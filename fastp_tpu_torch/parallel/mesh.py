"""Data-parallel execution of a step over several devices.

Counterpart of fastp_tpu/parallel/mesh.py.  The reference scales with
worker threads over read packs (src/peprocessor.cpp:750-754); fastp_tpu
shards every batch on its row axis over a device mesh and lets the compiler
split the step.  Here the split is made by hand: `--devices N` gives a list
of N torch.devices (make_mesh), every batch pads to a multiple of N
(pad_to_multiple, and the processors' _pad_batch), and the step of a split
(build_sharded_step) cuts each batch-major argument into N equal parts,
queues the upload and the device work of every part on its own device before
it fetches any, and joins what comes back: per-read outputs in shard order,
the batch's sums added up on the host.  Every shard of a paired-end step
launches the overlap kernel (ops/overlap_cuda.py) on its own device and
stream.

init_distributed starts the exchange between shards of one job on several
hosts (parallel/multihost.py) over torch.distributed.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..pipeline.device import ACC_KEYS, aux_arg_names

_dist_initialized = False
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# what a rank waits for the others in a collective before it gives up: the
# wait of the file exchange (parallel/multihost.py)
DIST_TIMEOUT_S = 600


def init_distributed() -> bool:
    """Multi-host initialisation (once per process, before the run asks
    parallel/multihost.py whether it is a shard).

    With MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE (> 1) set, start a
    torch.distributed process group with the gloo backend: what the shards
    exchange is pickled host state (Bloom positions, stats), so the group
    needs no card.  A no-op for a run on one host, and for a shard of
    --local_processes, whose exchange goes through files."""
    global _dist_initialized
    if _dist_initialized:
        return True
    env = os.environ
    if int(env.get("FASTP_TPU_SHARD_COUNT") or 0) > 1:
        return False
    if not all(env.get(k) for k in DIST_ENV) or int(env["WORLD_SIZE"]) <= 1:
        return False
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="tcp://%s:%s" % (env["MASTER_ADDR"],
                                             env["MASTER_PORT"]),
        rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    # latch only after success so a transient failure of the rendezvous can
    # be retried by a later job in the same (resident) process
    _dist_initialized = True
    return True


def process_group():
    """(rank, world size) of the group init_distributed started, else None.
    Imports torch.distributed only when there is one."""
    if not _dist_initialized:
        return None
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size()


def make_mesh(n_devices: int, device) -> list:
    """The torch.devices of a split, one per shard, local devices only (the
    shards of several hosts each split their own batches; what crosses
    hosts is the stats layer, parallel/multihost.py).

    `device` is the run's device request (cli.py:resolve_devices): one
    torch.device or a list of them.  `n_devices` is --devices, 0 when not
    given.

    * a list of several devices names the split outright and may repeat
      one, which puts several shards on one card; --devices N takes its
      first N, and N above its length raises;
    * `cuda` with no index: cuda:0 .. cuda:N-1, and with N = 0 every card
      torch sees (on a host with one card: that card, unsplit).  N above
      torch.cuda.device_count() raises and names the count;
    * `cuda:K` names one card and the run stays on it; asking for N > 1
      shards of it raises (name them as a list);
    * `cpu`: N shards of the CPU, one without --devices (the CPU has no
      count)."""
    req = ([torch.device(d) for d in device]
           if isinstance(device, (list, tuple)) else [torch.device(device)])
    if n_devices < 0:
        raise ValueError("--devices %d: a count of devices is 0 or more"
                         % n_devices)
    if len(req) > 1:
        if n_devices > len(req):
            raise ValueError("--devices %d: the device request names %d (%s)"
                             % (n_devices, len(req),
                                ",".join(str(d) for d in req)))
        return req[:n_devices] if n_devices else req
    dev = req[0]
    if dev.type == "cpu":
        return [dev] * max(1, n_devices)
    if dev.index is not None:
        if n_devices > 1:
            raise ValueError(
                "--devices %d: the device request %s names one card; name "
                "the devices of the split as a comma list (%s)"
                % (n_devices, dev, ",".join([str(dev)] * n_devices)))
        return [dev]
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise RuntimeError("--devices %d: torch sees %d CUDA device(s)"
                           % (n, count))
    if n == 1:
        return [dev]
    return [torch.device("cuda", i) for i in range(n)]


def pad_to_multiple(arrays_1d_or_2d, n: int, batch: int):
    """Pad batch-major numpy arrays so batch % n == 0.

    Returns (padded_list, valid_mask, padded_batch)."""
    rem = batch % n
    pad = 0 if rem == 0 else n - rem
    out = []
    for a in arrays_1d_or_2d:
        if pad == 0:
            out.append(a)
        else:
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            out.append(np.pad(a, widths))
    valid = np.ones(batch + pad, bool)
    if pad:
        valid[batch:] = False
    return out, valid, batch + pad


# how the join treats a step's outputs, BY KEY.  A leaf's shape cannot say
# what it is: a 128-row shard's per-read leaves are as long as the quality
# histogram, and a 1024-row shard's as long as the 5-mer histogram's used
# part.  Every stat_batch dict and these leaves are sums over the batch:
SUMMED_KEYS = ACC_KEYS + ("corrected_reads", "um_both_pass")
# per-row matrices with the rows on axis 1 ([K, B] and [2K, B])
ROWS_ON_AXIS1_KEYS = ("c1k_pos", "c2k_pos", "c1k_u8", "c2k_u8")
# the unsplit step's batch-level correction lists have no per-shard form
_SPARSE_LIST_KEYS = tuple(side + "_" + f for side in ("c1", "c2")
                          for f in ("rows", "pos", "base", "qual", "count"))


def join_outputs(outs: list, rows: int) -> dict:
    """One output dict from the shards' (numpy) dicts, each of `rows` rows:
    per-read leaves concatenated in shard order, the [K, B] matrices on
    axis 1, sums added in int64."""
    res = {}
    for k, v in outs[0].items():
        if isinstance(v, dict):
            res[k] = {dk: sum(np.asarray(o[k][dk], np.int64) for o in outs)
                      for dk in v}
        elif k in SUMMED_KEYS:
            res[k] = sum(np.asarray(o[k], np.int64) for o in outs)
        elif k in ROWS_ON_AXIS1_KEYS:
            res[k] = np.concatenate([o[k] for o in outs], axis=1)
        elif k in _SPARSE_LIST_KEYS:
            raise ValueError("%s: a batch-level list cannot be joined across "
                             "shards (build the shards with rowwise=True)" % k)
        else:
            if v.ndim < 1 or v.shape[0] != rows:
                raise ValueError("%s: shape %s is not per-read for shards of "
                                 "%d rows; name the key in SUMMED_KEYS or "
                                 "ROWS_ON_AXIS1_KEYS" % (k, v.shape, rows))
            res[k] = np.concatenate([o[k] for o in outs], axis=0)
    return res


class ShardedPending:
    """The pending fetches of a split batch's shards; wait() joins them."""

    def __init__(self, pendings: list, rows: int):
        self.pendings = pendings
        self.rows = rows

    def wait(self) -> dict:
        return join_outputs([p.wait() for p in self.pendings], self.rows)


class ShardedStep:
    """The step of a split: `run` cuts the batch and queues every shard's
    upload and device work (each on the side stream of its device),
    `start_fetch` packs every shard's outputs and queues their copies to the
    host, and the pending fetch's wait() joins them.  Same parts as
    pipeline/device.py:Step."""

    def __init__(self, steps: list, n_args: int):
        self.steps = steps          # one per shard; shards on one device share it
        self.n_args = n_args        # batch-major arguments, then nvalid

    def on_stream(self):
        """Every shard enters its own device's stream itself."""
        return contextlib.nullcontext()

    def run(self, *args, accum: bool = False):
        """Every shard's upload and device work; a shard runs with its index,
        so that shards on one device, which share a step, replay graphs of
        their own and no shard overwrites another's outputs before they are
        fetched.  The batch's sums are joined on the host (no `accum`)."""
        if accum:
            raise ValueError("a split batch's sums are joined on the host")
        n = len(self.steps)
        assert len(args) == self.n_args + 1, (len(args), self.n_args)
        batch = len(args[2])        # the first lengths vector
        if batch % n:
            raise ValueError("a batch of %d rows does not split into %d "
                             "equal shards (pad_to_multiple)" % (batch, n))
        rows = batch // n
        nvalid = int(args[-1])      # the valid rows are a prefix of the batch
        outs = []
        for k, step in enumerate(self.steps):
            lo = k * rows
            part = [a[lo:lo + rows] for a in args[:-1]]
            part.append(np.int32(min(max(nvalid - lo, 0), rows)))
            outs.append(step.run(*part, shard=k))
        return outs, rows

    def start_fetch(self, run_result) -> ShardedPending:
        outs, rows = run_result
        return ShardedPending([step.start_fetch(o)
                               for step, o in zip(self.steps, outs)], rows)

    def fetch(self, run_result) -> dict:
        return self.start_fetch(run_result).wait()

    def __call__(self, *args):
        return self.fetch(self.run(*args))


def build_sharded_step(build, cfg, devices: list) -> ShardedStep:
    """Wrap a device step for a split over `devices`.

    build: pipeline/device.py:build_se_step or build_pe_step, or either
    through the memo (memo_step); it is called once per DISTINCT device (a
    step uploads its adapters to its device), the PE step with
    rowwise=True.  Every argument of the step but the last is
    batch-major and is cut on its row axis; the last is the count of valid
    rows, of which every shard gets its own."""
    by_device = {}
    for d in devices:
        if d not in by_device:
            by_device[d] = (build(cfg, d, rowwise=True) if cfg.paired
                            else build(cfg, d))
    n_args = (6 if cfg.paired else 3) + len(aux_arg_names(cfg)) - 1
    return ShardedStep([by_device[d] for d in devices], n_args)
