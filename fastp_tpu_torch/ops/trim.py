"""Global trimming + sliding-window quality cutting.

Counterpart of fastp_tpu/ops/trim.py (reference: src/filter.cpp:83-222):
window means from cumulative sums, "first index where..." selections that
replicate the loop's exact break semantics, including
  * the `if (s > 0) s = s + w - 1` forwarding quirk
  * leading/trailing 'N' stripping after front/tail cuts
  * `cut_right` keeping good bases inside the low-quality window
  * NULL (dropped-read) conditions `rlen <= 0 || front >= l-1` and the
    window-does-not-fit checks.
Returns (front, rlen, alive) per read; alive=False corresponds to the
reference returning NULL.
"""
from __future__ import annotations

import torch

from .common import I32, pos_iota, first_true_index, last_true_index, N


def _window_sums(quals_i32, w: int):
    """sums[b, s] = sum(quals[s : s+w]) for any s (0 beyond row end)."""
    B, L = quals_i32.shape
    c = torch.cat([torch.zeros((B, 1), dtype=I32, device=quals_i32.device),
                   quals_i32.cumsum(1, dtype=I32)], 1)  # [B, L+1]
    total = c[:, L:L + 1]
    if w <= L:
        end = torch.cat([c[:, w:], total.expand(B, w - 1)], 1)
    else:
        end = total.expand(B, L)
    return end - c[:, :L]


def trim_and_cut(bases, quals, lengths, front_arg: int, tail_arg: int, cfg):
    """reference: src/filter.cpp:83-222 (Filter::trimAndCut).

    cfg exposes enabledFront/enabledTail/enabledRight and the window
    sizes and mean qualities of each.  Returns (front[B], rlen[B], alive[B])."""
    B, L = bases.shape
    dev = bases.device
    q = quals.to(I32)
    l = lengths.to(I32)
    pos = pos_iota(B, L, dev)

    any_cut = cfg.enabledFront or cfg.enabledTail or cfg.enabledRight

    if front_arg == 0 and tail_arg == 0 and not any_cut:
        return (torch.zeros_like(l), l, torch.ones(B, dtype=torch.bool, device=dev))

    rlen = l - front_arg - tail_arg
    if not any_cut:
        alive = rlen >= 0
        return (torch.where(alive, front_arg, 0).to(I32),
                torch.where(alive, rlen, 0), alive)

    alive = torch.ones(B, dtype=torch.bool, device=dev)
    front = torch.full_like(l, front_arg)

    if cfg.enabledFront:
        w = cfg.windowSizeFront
        thresh = (33 + cfg.qualityFront) * w
        alive = alive & (l - front - tail_arg - w > 0)
        sums = _window_sums(q, w)
        hit = (sums >= thresh) & (pos >= front[:, None]) & \
            (pos < (l - tail_arg - w)[:, None])
        s = first_true_index(hit, default=l - tail_arg - w)
        s = torch.where(s > 0, s + w - 1, s)
        non_n = (bases != N) & (pos >= s[:, None]) & (pos < l[:, None])
        front = first_true_index(non_n, default=l)
        rlen = l - front - tail_arg

    if cfg.enabledRight:
        w = cfg.windowSizeRight
        qr = 33 + cfg.qualityRight
        alive = alive & (l - front - tail_arg - w > 0)
        sums = _window_sums(q, w)
        low = (sums < qr * w) & (pos >= front[:, None]) & \
            (pos < (l - tail_arg - w)[:, None])
        s = first_true_index(low, default=torch.zeros_like(l))
        # while s < l-1 and qual[s] >= qr: s++
        bad_or_end = ((q < qr) | (pos >= (l - 1)[:, None])) & (pos >= s[:, None])
        s2 = first_true_index(bad_or_end, default=l - 1)
        rlen = torch.where(low.any(1), s2 - front, rlen)

    if cfg.enabledTail and not cfg.enabledRight:
        w = cfg.windowSizeTail
        thresh = (33 + cfg.qualityTail) * w
        alive = alive & (l - front - tail_arg - w > 0)
        sums = _window_sums(q, w)
        # window ending at t covers [t-w+1, t]: sums shifted right by w-1
        if w - 1 >= L:
            sums_sh = torch.zeros_like(sums)
        elif w > 1:
            sums_sh = torch.cat([torch.zeros((B, w - 1), dtype=I32, device=dev),
                                 sums[:, :L - (w - 1)]], 1)
        else:
            sums_sh = sums
        win_ok = (pos <= (l - tail_arg - 1)[:, None]) & \
            (pos >= (front + w)[:, None]) & (pos - w + 1 >= 0)
        good = win_ok & (sums_sh >= thresh)
        # the loop walks t downwards and breaks at the largest good t
        t = last_true_index(good, default=front + w - 1)
        t = torch.where(t < l - 1, t - w + 1, t)
        # strip trailing Ns: while t >= 0 and seq[t]=='N': t--
        t = last_true_index((bases != N) & (pos <= t[:, None]), default=-1)
        rlen = t - front + 1

    alive = alive & (rlen > 0) & (front < l - 1)
    return (torch.where(alive, front, 0), torch.where(alive, rlen, 0), alive)
