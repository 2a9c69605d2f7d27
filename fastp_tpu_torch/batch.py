"""Folder-level batch runner (reference: parallel.py).

Scans a directory for FASTQ files, pairs ``*R1*``/``*R2*`` companions,
preprocesses every file/pair, and aggregates all JSON reports into
``overall.html``.

Instead of fanning out one process per file (the reference spawns fastp
processes, parallel.py:146-158), files go one after another through this
process, which resolves the device once and pays for the CUDA context and
the kernel's library once; `--parallel` optionally shards the file list
across worker subprocesses of the port.

Usage: python -m fastp_tpu_torch.batch -i <dir> -o <dir> -r <reports> -a '<args>'
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List, Optional

FQ_EXTS = (".fq.gz", ".fastq.gz", ".fq", ".fastq")


def match_flag(filename: str, flag: str) -> bool:
    """reference: parallel.py:40-44"""
    if flag.endswith((".", "_", "-")):
        return flag in filename
    return any(flag + sep in filename for sep in (".", "_", "-"))


def base_name(filename: str) -> Optional[str]:
    for ext in FQ_EXTS:
        if filename.endswith(ext):
            return filename[: -len(ext)]
    return None


def scan_dir(folder: str, read1_flag: str = "R1", read2_flag: str = "R2"):
    """Pair up FASTQ files (reference: parallel.py:51-104).
    Returns a list of (read1_path, read2_path_or_None)."""
    if not os.path.isdir(folder):
        return []
    jobs = []
    processed = set()
    for f in sorted(os.listdir(folder)):
        path = os.path.join(folder, f)
        if os.path.isdir(path) or base_name(f) is None or path in processed:
            continue
        if match_flag(f, read2_flag):
            continue
        processed.add(path)
        if f.startswith("Undetermined"):
            continue
        if match_flag(f, read1_flag):
            read2 = path.replace(read1_flag, read2_flag)
            if os.path.exists(read2):
                processed.add(read2)
                jobs.append((path, read2))
            else:
                jobs.append((path, None))
        else:
            jobs.append((path, None))
    return jobs


def build_args(job, out_dir, report_dir, extra_args: List[str],
               read1_flag: str = "R1"):
    """Per-job CLI argv (reference: parallel.py:106-139)."""
    r1, r2 = job
    args = ["-i", r1]
    if r2:
        args += ["-I", r2]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        p1 = os.path.join(out_dir, os.path.basename(base_name(r1)))
        args += ["-o", p1 + ".clean.fastq.gz"]
        if r2:
            p2 = os.path.join(out_dir, os.path.basename(base_name(r2)))
            args += ["-O", p2 + ".clean.fastq.gz"]
    args += list(extra_args)
    rep = os.path.join(report_dir,
                       os.path.basename(r1).replace(read1_flag, "pe"))
    args += ["--html", rep + ".html", "--json", rep + ".json"]
    return args


def run_jobs_inprocess(jobs, out_dir, report_dir, extra_args, read1_flag,
                       device):
    """Every job through cli.main in this process, on `device`."""
    from .cli import main as cli_main
    for job in jobs:
        argv = build_args(job, out_dir, report_dir, extra_args, read1_flag)
        print("Processing: " + " ".join(argv))
        cli_main(["fastp_tpu_torch"] + argv, device)


def run_jobs_subprocess(jobs, out_dir, report_dir, extra_args, read1_flag,
                        parallel: int, device):
    """Shard the job list over `parallel` worker processes on `device`."""
    from concurrent.futures import ThreadPoolExecutor
    from .cli import DEVICE_ENV
    env = dict(os.environ)
    env[DEVICE_ENV] = str(device)

    def run_one(job):
        argv = build_args(job, out_dir, report_dir, extra_args, read1_flag)
        print("Running: fastp_tpu_torch " + " ".join(argv))
        res = subprocess.run([sys.executable, "-m", "fastp_tpu_torch"] + argv,
                             capture_output=True, text=True, env=env)
        return res.stderr[-2000:] if res.returncode else ""

    with ThreadPoolExecutor(max_workers=parallel) as ex:
        for r in ex.map(run_one, jobs):
            if r:
                sys.stderr.write(r + "\n")


def _svg_curves(curves, title, width=560, height=160):
    """Self-contained SVG overlay of per-file before/after curves (no CDN
    scripts; the reference pulls Chart.js/Plotly from a CDN)."""
    allpts = [c for e in curves for c in (e["curve_before"], e["curve_after"]) if c]
    if not allpts:
        return ""
    maxlen = max(len(c) for c in allpts)
    lo = min(min(c) for c in allpts)
    hi = max(max(c) for c in allpts)
    if hi <= lo:
        hi = lo + 1
    palette = ["#2980b9", "#c0392b", "#27ae60", "#8e44ad", "#d35400",
               "#16a085", "#7f8c8d", "#2c3e50"]
    out = ['<h4>%s</h4><svg viewBox="0 0 %d %d" width="%d" height="%d" '
           'style="background:#fff;border:1px solid #e1e4e8">'
           % (title, width, height, width, height)]
    for idx, e in enumerate(curves):
        color = palette[idx % len(palette)]
        for key, dash in (("curve_before", ' stroke-dasharray="3,3"'),
                          ("curve_after", "")):
            c = e[key]
            if not c:
                continue
            pts = " ".join("%.1f,%.1f" % (4 + (width - 8) * i / max(1, maxlen - 1),
                                          height - 4 - (height - 8) * (v - lo) / (hi - lo))
                           for i, v in enumerate(c))
            out.append('<polyline fill="none" stroke="%s" stroke-width="1"%s '
                       'points="%s"><title>%s</title></polyline>'
                       % (color, dash, pts, e["file"]))
    out.append("</svg>")
    return "".join(out)


def human_format(num):
    """reference: parallel.py:312-320"""
    if num >= 1e9:
        return "%.2fG" % (num / 1e9)
    if num >= 1e6:
        return "%.2fM" % (num / 1e6)
    if num >= 1e3:
        return "%.2fK" % (num / 1e3)
    return str(num)


def generate_summary_html(report_dir: str):
    """Aggregate every fastp JSON in report_dir into overall.html
    (reference: parallel.py:160-565)."""
    json_files = sorted(f for f in os.listdir(report_dir) if f.endswith(".json"))
    version = "fastp_tpu_torch"
    stats, qcurves, gcurves, qcurves2, gcurves2 = [], [], [], [], []
    for jf in json_files:
        try:
            with open(os.path.join(report_dir, jf)) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        summary = data.get("summary", {})
        version = "fastp_tpu_torch " + summary.get("fastp_version", "")
        before = summary.get("before_filtering", {})
        after = summary.get("after_filtering", {})
        name = jf[:-5]
        for side, qc, gc in (("read1", qcurves, gcurves),
                             ("read2", qcurves2, gcurves2)):
            qb = data.get(side + "_before_filtering", {}).get(
                "quality_curves", {}).get("mean", [])
            qa = data.get(side + "_after_filtering", {}).get(
                "quality_curves", {}).get("mean", [])
            gb = data.get(side + "_before_filtering", {}).get(
                "content_curves", {}).get("GC", [])
            ga = data.get(side + "_after_filtering", {}).get(
                "content_curves", {}).get("GC", [])
            if qb or qa:
                qc.append({"file": name, "curve_before": qb, "curve_after": qa})
            if gb or ga:
                gc.append({"file": name, "curve_before": gb, "curve_after": ga})
        stats.append({
            "file": name,
            "total_reads_before": before.get("total_reads", 0),
            "total_reads_after": after.get("total_reads", 0),
            "total_bases_before": before.get("total_bases", 0),
            "total_bases_after": after.get("total_bases", 0),
            "q20_rate_before": before.get("q20_rate", 0) * 100,
            "q20_rate_after": after.get("q20_rate", 0) * 100,
            "q30_rate_before": before.get("q30_rate", 0) * 100,
            "q30_rate_after": after.get("q30_rate", 0) * 100,
            "gc_content_before": before.get("gc_content", 0) * 100,
            "gc_content_after": after.get("gc_content", 0) * 100,
            "html_report": name + ".html",
        })

    rows = []
    for s in stats:
        rows.append(
            "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
            "<td>%.2f%%</td><td>%.2f%%</td><td>%.2f%%</td><td>%.2f%%</td>"
            "<td>%.2f%%</td><td>%.2f%%</td><td><a href=\"%s\">View</a></td></tr>"
            % (s["file"], human_format(s["total_reads_before"]),
               human_format(s["total_reads_after"]),
               human_format(s["total_bases_before"]),
               human_format(s["total_bases_after"]),
               s["q20_rate_before"], s["q20_rate_after"],
               s["q30_rate_before"], s["q30_rate_after"],
               s["gc_content_before"], s["gc_content_after"],
               s["html_report"]))

    html = """<!DOCTYPE html>
<html lang="en"><head><meta charset="UTF-8"><title>FASTQ Summary Report</title>
<style>
body { font-family: 'Segoe UI', Arial, sans-serif; background:#f8f9fa; padding:2em; }
h2 { color:#2c3e50; } table { border-collapse:collapse; width:100%%; background:#fff; }
th,td { border:1px solid #e1e4e8; padding:.6em 1em; text-align:center; }
th { background:#f3f6fa; color:#34495e; } tr:nth-child(even){background:#f9fafb;}
a { color:#2980b9; text-decoration:none; }
</style></head><body>
<h2>FASTQ Aggregate Summary (%s)</h2>
<table><thead><tr><th>File</th><th>Total Reads (Before)</th><th>Total Reads (After)</th>
<th>Total Bases (Before)</th><th>Total Bases (After)</th><th>Q20 Rate (Before)</th>
<th>Q20 Rate (After)</th><th>Q30 Rate (Before)</th><th>Q30 Rate (After)</th>
<th>GC Content (Before)</th><th>GC Content (After)</th><th>HTML Report</th></tr></thead>
<tbody>%s</tbody></table>
%s%s%s%s
<p style="color:#7f8c8d">dashed = before filtering, solid = after filtering</p>
</body></html>
""" % (version, "".join(rows),
        _svg_curves(qcurves, "Read1 mean quality curves"),
        _svg_curves(gcurves, "Read1 GC content curves"),
        _svg_curves(qcurves2, "Read2 mean quality curves"),
        _svg_curves(gcurves2, "Read2 GC content curves"))

    out = os.path.join(report_dir, "overall.html")
    with open(out, "w") as f:
        f.write(html)
    print("Summary report: " + out)


def main(argv=None, device=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog="fastp_tpu_torch.batch",
        description="preprocess all FASTQ files within a folder")
    ap.add_argument("-i", "--input_dir", default=".")
    ap.add_argument("-o", "--out_dir", default=None)
    ap.add_argument("-r", "--report_dir", default=None)
    ap.add_argument("-a", "--args", default=None,
                    help="extra arguments passed to every run, quoted")
    ap.add_argument("-p", "--parallel", type=int, default=None,
                    help="worker processes; default 1 (every file through "
                         "this process and its one CUDA context)")
    ap.add_argument("-1", "--read1_flag", default="R1")
    ap.add_argument("-2", "--read2_flag", default="R2")
    opts = ap.parse_args(argv)
    # once, before anything is written: the card unless the caller asks
    # for the CPU, and no card and no request is an error
    # (of a comma list, which names the devices of a split, the first)
    from .cli import resolve_device
    device = resolve_device(device)

    report_dir = opts.report_dir or opts.out_dir or opts.input_dir
    os.makedirs(report_dir, exist_ok=True)
    extra = opts.args.split() if opts.args else []

    jobs = scan_dir(opts.input_dir, opts.read1_flag, opts.read2_flag)
    if not jobs:
        print("No FASTQ file found, do you call the program correctly?")
        return 1

    t0 = time.time()
    if opts.parallel and opts.parallel > 1:
        run_jobs_subprocess(jobs, opts.out_dir, report_dir, extra,
                            opts.read1_flag, opts.parallel, device)
    else:
        run_jobs_inprocess(jobs, opts.out_dir, report_dir, extra,
                           opts.read1_flag, device)
    generate_summary_html(report_dir)
    print("Batch done: %d file set(s) in %.1fs" % (len(jobs), time.time() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
