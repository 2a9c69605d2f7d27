"""HTML report emitter (reference: src/htmlreporter.cpp).

Self-contained HTML with embedded Plotly-based curves mirroring the
reference's sections: summary, filtering result, duplication, insert size,
adapters, quality/content/kmer/ORA per read end, before/after filtering.
"""
from __future__ import annotations

import time

import numpy as np

from ..config import Options, FASTP_TPU_VER, PASS_FILTER, FAIL_QUALITY, \
    FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_COMPLEXITY
from .stats_model import Stats, cpp_num, kmer2, kmer3
from .filter_model import FilterResult


def _fmt_number(n: int) -> str:
    """reference: src/htmlreporter.cpp:34-46 (formatNumber, K/M/G suffixes;
    note the strict `> 1000.0` and std::to_string's fixed 6 decimals)."""
    num = float(n)
    units = ["", "K", "M", "G", "T", "P"]
    order = 0
    while num > 1000.0 and order < len(units) - 1:
        order += 1
        num /= 1000.0
    if order == 0:
        return str(int(n))
    return "%.6f %s" % (num, units[order])


def _pct(num, den) -> str:
    """reference: src/htmlreporter.cpp:49-54 (getPercents + '%')"""
    if den == 0:
        return "0.0%"
    return "%.6f%%" % (num * 100.0 / den)


def _cycle_samples(cycles: int, long_read: bool):
    """x coordinates for curve plots; long reads (>300 cycles) downsample
    geometrically (x1.05) after the first 40 cycles
    (reference: src/stats.cpp:761-788)."""
    if not long_read:
        return list(range(1, cycles + 1))
    x = list(range(1, min(40, cycles) + 1))
    if cycles > 40:
        pos = 40.0
        while True:
            pos *= 1.05
            if pos >= cycles:
                break
            x.append(int(pos))
        if x[-1] != cycles:
            x.append(cycles)
    return x


def _sample_curve(curve, coords) -> str:
    """Window-averaged curve values over (coords[i-1], coords[i]] buckets
    (reference: src/stats.cpp:507-531 list2string with coords)."""
    out = []
    start = 0
    for c in coords:
        if c == start:
            out.append("0.0")
        else:
            seg = curve[start:c]
            out.append(cpp_num(float(np.sum(seg)) / (c - start)))
        start = c
    return ",".join(out)


class HtmlReporter:
    def __init__(self, opt: Options):
        self.opt = opt
        self.dup_rate = 0.0
        self.insert_hist = None
        self.insert_size_peak = 0

    def set_dup(self, dup_rate: float):
        self.dup_rate = dup_rate

    def set_insert_hist(self, hist, peak: int):
        self.insert_hist = hist
        self.insert_size_peak = peak

    def _curves_section(self, w, st: Stats, filtering_type: str, read_name: str):
        st.summarize()
        div_base = ("%s: %s" % (filtering_type, read_name)).replace(" ", "_").replace(":", "_")
        cycles = st.cycles
        long_read = st.is_long_read()
        # >300-cycle reads: geometric cycle downsampling + log x axis
        # (reference: src/stats.cpp:761-788, :802-804)
        x = _cycle_samples(cycles, long_read)
        xs = ",".join(map(str, x))
        log_axis = ",type:'log'" if long_read else ""
        # quality curves
        w("<div class='subsection_title'>%s: %s: quality</div>\n" % (filtering_type, read_name))
        w("<div class='figure' id='plot_q_%s'></div>\n" % div_base)
        w("<script type=\"text/javascript\">\n")
        w("var data=[")
        colors = {"A": "rgba(128,128,0,1.0)", "T": "rgba(128,0,128,1.0)",
                  "C": "rgba(0,255,0,1.0)", "G": "rgba(0,0,255,1.0)",
                  "mean": "rgba(20,20,20,1.0)"}
        for base in ["A", "T", "C", "G", "mean"]:
            curve = st.quality_curves[base]
            w("{x:[%s],y:[%s],name:'%s',mode:'lines',line:{color:'%s',width:1}},"
              % (xs, _sample_curve(curve, x), base, colors[base]))
        w("];\n")
        w("Plotly.newPlot('plot_q_%s', data, {xaxis:{title:'position'%s}, yaxis:{title:'quality'}});\n"
          % (div_base, log_axis))
        w("</script>\n")
        # content curves (legend carries the overall percentage,
        # reference: src/stats.cpp:861-874)
        w("<div class='subsection_title'>%s: %s: base contents</div>\n" % (filtering_type, read_name))
        w("<div class='figure' id='plot_c_%s'></div>\n" % div_base)
        w("<script type=\"text/javascript\">\n")
        w("var data=[")
        colors2 = {"A": "rgba(128,128,0,1.0)", "T": "rgba(128,0,128,1.0)",
                   "C": "rgba(0,255,0,1.0)", "G": "rgba(0,0,255,1.0)",
                   "N": "rgba(255, 0, 0, 1.0)", "GC": "rgba(20,20,20,1.0)"}
        for base in ["A", "T", "C", "G", "N", "GC"]:
            curve = st.content_curves[base]
            if len(base) == 1:
                count = int(st.base_contents[ord(base) & 0x07])
            else:
                count = int(st.base_contents[ord("G") & 7]
                            + st.base_contents[ord("C") & 7])
            pct = ("%f" % (count * 100.0 / max(st.bases, 1)))[:5]
            w("{x:[%s],y:[%s],name:'%s(%s%%)',mode:'lines',line:{color:'%s',width:1}},"
              % (xs, _sample_curve(curve, x), base, pct, colors2[base]))
        w("];\n")
        w("Plotly.newPlot('plot_c_%s', data, {xaxis:{title:'position'%s}, yaxis:{title:'base content ratios'}});\n"
          % (div_base, log_axis))
        w("</script>\n")
        # kmer table
        w("<div class='subsection_title'>%s: %s: KMER counting</div>\n" % (filtering_type, read_name))
        w("<table class='kmer_table'>\n<tr><td></td>")
        for h in range(16):
            w("<td>%s</td>" % kmer2(h))
        w("</tr>\n")
        mean_bases = (st.bases + 1) / 2048.0
        for i in range(64):
            w("<tr><td>%s</td>" % kmer3(i))
            for j in range(16):
                target = (i << 4) + j
                val = int(st.kmer[target])
                prop = val / mean_bases
                frac = 0.5
                if prop > 2.0:
                    frac = (prop - 2.0) / 20.0 + 0.5
                elif prop < 0.5:
                    frac = prop
                frac = max(0.01, min(1.0, frac))
                r = int((1.0 - frac) * 255)
                w("<td style='background:#%02x%02x%02x' title='%s%s: %d'>%s%s</td>"
                  % (r, r, r, kmer3(i), kmer2(j), val, kmer3(i), kmer2(j)))
            w("</tr>\n")
        w("</table>\n")
        # overrepresented sequences with per-cycle distribution canvases
        # (reference: src/stats.cpp:567-651 reportHtmlORA)
        if self.opt.overRepAnalysis.enabled:
            div_name = ("%s: %s: overrepresented sequences"
                        % (filtering_type, read_name)).replace(" ", "_").replace(":", "_")
            passed = [seq for seq in sorted(st.overrep)
                      if st.overrep_passed(seq, st.overrep[seq])]
            w("<div class='subsection_title'>%s: %s: overrepresented sequences</div>\n"
              % (filtering_type, read_name))
            w("<div id='%s'>\n" % div_name)
            w("<div class='sub_section_tips'>Sampling rate: 1 / %d</div>\n"
              % self.opt.overRepAnalysis.sampling)
            w("<table class='summary_table'>\n")
            w("<tr style='font-weight:bold;'><td>overrepresented sequence</td>"
              "<td>count (%% of bases)</td>"
              "<td>distribution: cycle 1 ~ cycle %d</td></tr>\n"
              % st.evaluated_seq_len)
            for seq in passed:
                count = st.overrep[seq]
                pct = (100.0 * count * len(seq) * self.opt.overRepAnalysis.sampling) / max(st.bases, 1)
                w("<tr><td width='400' style='word-break:break-all;font-size:8px;'>%s</td>"
                  "<td width='200'>%d (%.6f%%)</td>"
                  "<td width='250'><canvas id='%s_%s' width='240' height='20'></td></tr>\n"
                  % (seq, count, pct, div_name, seq))
            if not passed:
                w("<tr><td style='text-align:center' colspan='3'>not found</td></tr>\n")
            w("</table>\n</div>\n")
            # distribution canvas painter (reference: src/stats.cpp:610-651)
            w("<script language='javascript'>\n")
            w("var seqlen = %d;\n" % st.evaluated_seq_len)
            w("var orp_dist = {\n")
            w(",\n".join('\t"%s_%s":[%s]' % (
                div_name, seq,
                ",".join(str(int(v)) for v in
                         st.overrep_dist[seq][:st.evaluated_seq_len]))
                for seq in passed))
            w("\n};\n")
            w("for (seq in orp_dist) {\n"
              "    var cvs = document.getElementById(seq);\n"
              "    var ctx = cvs.getContext('2d'); \n"
              "    var data = orp_dist[seq];\n"
              "    var w = 240;\n    var h = 20;\n"
              "    ctx.fillStyle='#cccccc';\n"
              "    ctx.fillRect(0, 0, w, h);\n"
              "    ctx.fillStyle='#0000FF';\n"
              "    var maxVal = 0;\n"
              "    for(d=0; d<seqlen; d++) {\n"
              "        if(data[d]>maxVal) maxVal = data[d];\n"
              "    }\n"
              "    var step = (seqlen-1) /  (w-1);\n"
              "    for(x=0; x<w; x++){\n"
              "        var target = step * x;\n"
              "        var val = data[Math.floor(target)];\n"
              "        var y = Math.floor((val / maxVal) * h);\n"
              "        ctx.fillRect(x,h-1, 1, -y);\n"
              "    }\n"
              "}\n")
            w("</script>\n")

    def report(self, result: FilterResult, pre1: Stats, post1: Stats,
               pre2: Stats = None, post2: Stats = None):
        opt = self.opt
        paired = opt.isPaired()
        with open(opt.htmlFile, "w") as f:
            w = f.write
            w("<!DOCTYPE html>\n<html>\n<head>\n<meta charset=\"utf-8\">\n")
            w("<script src=\"https://cdn.plot.ly/plotly-latest.min.js\"></script>\n")
            w("<title>%s</title>\n" % opt.reportTitle)
            w("<style>body{font-family:Arial;font-size:14px;}"
              ".summary_table{border-collapse:collapse;}"
              ".summary_table td{border:1px solid #eee;padding:3px 8px;}"
              ".kmer_table{border-collapse:collapse;font-size:8px;}"
              ".kmer_table td{padding:1px 2px;text-align:center;}"
              ".section_title{font-size:20px;color:#ffffff;background:#556699;"
              "padding:5px;margin-top:15px;cursor:pointer;}"
              ".subsection_title{font-size:16px;color:#556699;padding:4px 0;"
              "font-weight:bold;cursor:pointer;}"
              ".sub_section_tips{font-size:11px;color:#999999;padding:3px;}"
              "</style>\n")
            # reference: src/htmlreporter.cpp printJs -- collapsible sections
            w("<script type=\"text/javascript\">\n"
              "function showOrHide(divname){div=document.getElementById(divname);"
              "if(div.style.display=='none')div.style.display='block';"
              "else div.style.display='none';}\n</script>\n")
            w("</head>\n<body>\n")
            w("<h1 style='text-align:left;'>%s</h1>\n" % opt.reportTitle)

            pre_reads = pre1.get_reads() + (pre2.get_reads() if pre2 else 0)
            pre_bases = pre1.get_bases() + (pre2.get_bases() if pre2 else 0)
            pre_q20 = pre1.get_q20() + (pre2.get_q20() if pre2 else 0)
            pre_q30 = pre1.get_q30() + (pre2.get_q30() if pre2 else 0)
            pre_gc = pre1.get_gc_number() + (pre2.get_gc_number() if pre2 else 0)
            post_reads = post1.get_reads() + (post2.get_reads() if post2 else 0)
            post_bases = post1.get_bases() + (post2.get_bases() if post2 else 0)
            post_q20 = post1.get_q20() + (post2.get_q20() if post2 else 0)
            post_q30 = post1.get_q30() + (post2.get_q30() if post2 else 0)
            post_gc = post1.get_gc_number() + (post2.get_gc_number() if post2 else 0)

            pre_q40 = pre1.get_q40() + (pre2.get_q40() if pre2 else 0)
            post_q40 = post1.get_q40() + (post2.get_q40() if post2 else 0)

            def row(k, v):
                w("<tr><td class='col1'>%s</td><td class='col2'>%s</td></tr>\n" % (k, v))

            # reference: src/htmlreporter.cpp:115-166 (General section)
            w("<div class='section_title' onclick=showOrHide('summary')>"
              "<a name='summary'>Summary</a></div>\n")
            w("<div id='summary'>\n")
            w("<div class='subsection_title' onclick=showOrHide('general')>General</div>\n")
            w("<div id='general'>\n<table class='summary_table'>\n")
            seq_info = ("paired end (%d cycles + %d cycles)" % (pre1.get_cycles(), pre2.get_cycles())
                        if paired else "single end (%d cycles)" % pre1.get_cycles())
            row("fastp version:", "%s (fastp_tpu)" % FASTP_TPU_VER)
            row("sequencing:", seq_info)
            if paired:
                row("mean length before filtering:",
                    "%dbp, %dbp" % (pre1.get_mean_length(), pre2.get_mean_length()))
                if not opt.merge.enabled:
                    row("mean length after filtering:",
                        "%dbp, %dbp" % (post1.get_mean_length(), post2.get_mean_length()))
            else:
                row("mean length before filtering:", "%dbp" % pre1.get_mean_length())
                row("mean length after filtering:", "%dbp" % post1.get_mean_length())
            if opt.duplicate.enabled:
                dup_str = "%.6f%%" % (self.dup_rate * 100.0)
                if not paired:
                    dup_str += " (may be overestimated since this is SE data)"
                row("duplication rate:", dup_str)
            if paired:
                row("Insert size peak:", str(self.insert_size_peak))
            if opt.adapterCuttingEnabled():
                from ..knownadapters import get_known_adapters
                known = get_known_adapters()
                if opt.adapter.detectedAdapter1:
                    info = opt.adapter.detectedAdapter1
                    if info in known:
                        info += " -" + known[info]
                    row("Detected read1 adapter:", info)
                if opt.adapter.detectedAdapter2:
                    info = opt.adapter.detectedAdapter2
                    if info in known:
                        info += " -" + known[info]
                    row("Detected read2 adapter:", info)
            w("</table>\n</div>\n")

            for div_id, title, reads, bases, q20, q30, q40, gc in (
                    ("before_filtering_summary", "Before filtering", pre_reads,
                     pre_bases, pre_q20, pre_q30, pre_q40, pre_gc),
                    ("after_filtering_summary", "After filtering", post_reads,
                     post_bases, post_q20, post_q30, post_q40, post_gc)):
                w("<div class='subsection_title' onclick=showOrHide('%s')>%s</div>\n"
                  % (div_id, title))
                w("<div id='%s'>\n<table class='summary_table'>\n" % div_id)
                row("total reads:", _fmt_number(reads))
                row("total bases:", _fmt_number(bases))
                row("Q20 bases:", "%s (%s)" % (_fmt_number(q20), _pct(q20, bases)))
                row("Q30 bases:", "%s (%s)" % (_fmt_number(q30), _pct(q30, bases)))
                row("Q40 bases:", "%s (%s)" % (_fmt_number(q40), _pct(q40, bases)))
                row("GC content:", _pct(gc, bases))
                w("</table>\n</div>\n")

            w("<div class='subsection_title' onclick=showOrHide('filtering_result')>"
              "Filtering result</div>\n")
            w("<div id='filtering_result'>\n")
            w("<table class='summary_table'>\n")
            frs = result.filter_read_stats
            total = max(pre_reads, 1)
            row("reads passed filters:",
                "%s (%.6f%%)" % (_fmt_number(frs[PASS_FILTER]),
                                 frs[PASS_FILTER] * 100.0 / total))
            if opt.correction.enabled:
                row("reads corrected:",
                    "%s (%.6f%%)" % (_fmt_number(result.corrected_reads),
                                     result.corrected_reads * 100.0 / total))
                row("bases corrected:",
                    "%s (%.6f%%)" % (_fmt_number(result.get_total_corrected_bases()),
                                     result.get_total_corrected_bases() * 100.0 / max(pre_bases, 1)))
            row("reads with low quality:",
                "%s (%.6f%%)" % (_fmt_number(frs[FAIL_QUALITY]),
                                 frs[FAIL_QUALITY] * 100.0 / total))
            row("reads with too many N:",
                "%s (%.6f%%)" % (_fmt_number(frs[FAIL_N_BASE]),
                                 frs[FAIL_N_BASE] * 100.0 / total))
            if opt.lengthFilter.enabled:
                row("reads too short:",
                    "%s (%.6f%%)" % (_fmt_number(frs[FAIL_LENGTH]),
                                     frs[FAIL_LENGTH] * 100.0 / total))
                if opt.lengthFilter.maxLength > 0:
                    row("reads too long:",
                        "%s (%.6f%%)" % (_fmt_number(frs[FAIL_TOO_LONG]),
                                         frs[FAIL_TOO_LONG] * 100.0 / total))
            if opt.complexityFilter.enabled:
                row("reads with low complexity:",
                    "%s (%.6f%%)" % (_fmt_number(frs[FAIL_COMPLEXITY]),
                                     frs[FAIL_COMPLEXITY] * 100.0 / total))
            w("</table>\n</div>\n")
            w("</div>\n")  # closes #summary

            if paired and self.insert_hist is not None:
                # reference: src/htmlreporter.cpp:216-282 (reportInsertSize):
                # percent-based bars limited to cycles1+cycles2-overlapRequire,
                # with the non-overlapped fraction called out as "unknown".
                w("<div class='section_title' onclick=showOrHide('insert_size')>"
                  "<a name='insert_size'>Insert size estimation</a></div>\n")
                w("<div id='insert_size'>\n")
                isize_limit = max(1, pre1.get_cycles() + pre2.get_cycles()
                                  - opt.overlapRequire)
                total_bins = min(opt.insertSizeMax, isize_limit)
                hist = np.asarray(self.insert_hist, np.float64)
                all_count = float(hist[:total_bins].sum() + hist[opt.insertSizeMax])
                if all_count > 0:
                    percents = hist[:total_bins] * 100.0 / all_count
                    unknown_pct = float(hist[opt.insertSizeMax]) * 100.0 / all_count
                else:
                    percents = np.zeros(total_bins)
                    unknown_pct = float("nan")
                w("<div id='insert_size_figure'>\n")
                w("<div class='figure' id='plot_insert_size' style='height:400px;'></div>\n")
                w("</div>\n")
                w("<div class='sub_section_tips'>This estimation is based on paired-end "
                  "overlap analysis, and there are %.6f%% reads found not overlapped. "
                  "<br /> The nonoverlapped read pairs may have insert size &lt;%d or "
                  "&gt;%d, or contain too much sequencing errors to be detected as "
                  "overlapped.</div>\n"
                  % (unknown_pct, opt.overlapRequire, isize_limit))
                w("<script type=\"text/javascript\">\n")
                w("var data=[{x:[%s],y:[%s],name:'Percent (%%)  ',type:'bar',"
                  "line:{color:'rgba(128,0,128,1.0)', width:1}}];\n"
                  % (",".join(str(i) for i in range(total_bins)),
                     ",".join("%.6f" % v for v in percents)))
                w("var layout={title:'Insert size distribution (%.6f%% reads are with "
                  "unknown length)', xaxis:{title:'Insert size'}, "
                  "yaxis:{title:'Read percent (%%)'}};\n" % unknown_pct)
                w("Plotly.newPlot('plot_insert_size', data, layout);\n")
                w("</script>\n</div>\n")

            if result is not None and opt.adapterCuttingEnabled():
                w("<div class='section_title'>Adapters</div>\n")
                for title, counts in [("Adapter or bad ligation of read1", result.adapter1)] + (
                        [("Adapter or bad ligation of read2", result.adapter2)] if paired else []):
                    w("<div class='subsection_title'>%s</div>\n" % title)
                    w("<table class='summary_table'>\n")
                    w("<tr><td style='color:#ffffff;background:#556699'>Sequence</td>"
                      "<td style='color:#ffffff;background:#556699'>Occurrences</td></tr>\n")
                    tot = sum(counts.values())
                    reported = 0
                    for seq in sorted(counts):
                        c = counts[seq]
                        if tot and c / tot < 0.01:
                            continue
                        w("<tr><td>%s</td><td>%d</td></tr>\n" % (seq, c))
                        reported += c
                    if tot - reported > 0:
                        tag = "other adapter sequences" if reported else "all adapter sequences"
                        w("<tr><td>%s</td><td>%d</td></tr>\n" % (tag, tot - reported))
                    w("</table>\n")

            # per read-end curve sections
            w("<div class='section_title'>Before filtering</div>\n")
            self._curves_section(w, pre1, "Before filtering", "read1")
            if pre2 is not None:
                self._curves_section(w, pre2, "Before filtering", "read2")
            title_after = "After filtering"
            w("<div class='section_title'>%s</div>\n" % title_after)
            self._curves_section(w, post1, title_after,
                                 "merged" if opt.merge.enabled else "read1")
            if post2 is not None and not opt.merge.enabled:
                self._curves_section(w, post2, title_after, "read2")

            w("<div class='section_title'>Command</div>\n")
            w("<div style='font-size:12px;font-family:monospace'>%s</div>\n" % opt.command)
            w("</body>\n</html>\n")
