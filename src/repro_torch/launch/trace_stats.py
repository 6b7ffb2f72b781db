"""What the program did: op records and profiler statistics (counterpart of
``repro.launch.hlo_stats``, which reads a compiled program's HLO).

PyTorch runs eagerly, so there is no program text to read; this module
reads what a run did instead, from two sources:

* :class:`OpRecorder`, a ``TorchDispatchMode`` that logs each aten op with
  its input and output shapes, dtypes and devices, in order. While it is
  active it also logs each launch of a hand-written kernel
  (``kernels.ops._launch``, which the ``TorchDispatchMode`` cannot see),
  each ``torch.cuda.synchronize`` call, and the sharded routes' two
  transfers (``serve.sharded._to_shard`` and ``_send``) as one record
  each, the copies inside them left out. It works on the CPU and on the
  card, and slows every op by the Python hook: count with it, never time.
* :func:`profile`, a ``torch.profiler`` run on the card: kernels by name
  with their counts and device time, the device busy share of the host's
  wall clock, the longest idle gaps of the device, and the host's waits
  (``cuda*Synchronize`` runtime calls and device-to-host copies). Its
  parser :func:`profile_stats` reads the Chrome-trace events the profiler
  exports.

What counts as what on a mesh that is a device list:

* a **collective** is a sharded route's transfer: the query batch and
  its filter sent to a shard's device (``broadcast``) or a shard's packed
  merge payload sent to the lead device (``packed_gather``), one of each
  per shard per route call, counted also when the shards share a card
  and no byte crosses a link; or any other copy between two devices that
  are both not the CPU (``cross_device_copy``), which no route makes;
* a **host sync** is ``aten::_local_scalar_dense`` (``.item()``,
  ``bool``/``float``/``int`` of a tensor), an op whose output size the
  host must read (``aten::nonzero``, ``aten::masked_select``, indexing by
  a boolean mask), a copy from a CUDA device to the CPU, or an explicit
  ``torch.cuda.synchronize``. The first three are counted on the CPU too,
  so a CPU run predicts the card's count; a copy to the CPU is no op on
  the CPU and shows only on the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
          torch.int16: "i16", torch.int8: "i8", torch.uint8: "ui8",
          torch.bool: "i1"}

SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero",
            "aten::masked_select", "cuda::synchronize")
GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather",
              "aten::take", "aten::embedding")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: Tuple[int, ...]
    dtype: str           # "f32", "i32", ... (the reference's HLO names)
    device: str          # "cpu", "cuda:0", ...

    @property
    def key(self) -> str:
        """'256x8xf32': the reference audit's operand spelling."""
        return "x".join([str(s) for s in self.shape] + [self.dtype])

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        size = {"f64": 8, "i64": 8, "f32": 4, "i32": 4, "f16": 2, "bf16": 2,
                "i16": 2}.get(self.dtype, 1)
        return n * size


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a run: ``aten::<op>``, ``kernel::<name>`` (a hand-written
    kernel's launch), ``cuda::synchronize``, ``collective::broadcast`` or
    ``collective::packed_gather``; its tensor inputs (list arguments
    flattened) and outputs."""
    name: str
    inputs: Tuple[TensorSpec, ...] = ()
    outputs: Tuple[TensorSpec, ...] = ()


def spec(t: torch.Tensor) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in t.shape),
                      _DTYPE.get(t.dtype, str(t.dtype).replace("torch.", "")),
                      str(t.device))


def _specs(values) -> Tuple[TensorSpec, ...]:
    out: List[TensorSpec] = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(spec(v))
        elif isinstance(v, (list, tuple)):
            out.extend(spec(t) for t in v if isinstance(t, torch.Tensor))
    return tuple(out)


def _filter_tensors(filt) -> List[torch.Tensor]:
    if filt is None:
        return []
    leaves = filt.leaves() if hasattr(filt, "leaves") else [filt]
    return [v for f in leaves for v in f.data.values()]


class OpRecorder(TorchDispatchMode):
    """Record every op run inside ``with OpRecorder() as rec:`` into
    ``rec.records`` (see the module docstring). Kernel launches, the
    sharded routes' transfers and ``torch.cuda.synchronize`` are logged
    through wrappers that the recorder swaps in while it is active and
    restores on exit."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []
        self._saved: Dict[str, Callable] = {}
        self._quiet = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            outs = out if isinstance(out, (list, tuple)) else (out,)
            self.records.append(OpRecord(
                f"aten::{func.overloadpacket.__name__}",
                _specs(list(args) + list(kwargs.values())), _specs(outs)))
        return out

    def _transfer(self, fn, *args):
        """``fn(*args)`` without recording the copies inside it."""
        self._quiet += 1
        try:
            return fn(*args)
        finally:
            self._quiet -= 1

    def __enter__(self):
        from ..kernels import ops
        from ..serve import sharded
        launch, sync = ops._launch, torch.cuda.synchronize
        send, to_shard = sharded._send, sharded._to_shard
        self._saved = {"launch": launch, "sync": sync, "send": send,
                       "to_shard": to_shard}

        def logged_launch(name, *args):
            launch(name, *args)
            self.records.append(OpRecord(f"kernel::{name}", _specs(args)))

        def logged_sync(*a, **kw):
            self.records.append(OpRecord("cuda::synchronize"))
            return sync(*a, **kw)

        def logged_send(packed, device):
            out = self._transfer(send, packed, device)
            self.records.append(OpRecord("collective::packed_gather",
                                         _specs([packed]), _specs([out])))
            return out

        def logged_to_shard(queries, filt, device):
            q, f = self._transfer(to_shard, queries, filt, device)
            self.records.append(OpRecord(
                "collective::broadcast",
                _specs([[queries] + _filter_tensors(filt)]),
                _specs([[q] + _filter_tensors(f)])))
            return q, f

        ops._launch = logged_launch
        torch.cuda.synchronize = logged_sync
        sharded._send = logged_send
        sharded._to_shard = logged_to_shard
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import ops
        from ..serve import sharded
        try:
            return super().__exit__(*exc)
        finally:
            ops._launch = self._saved["launch"]
            torch.cuda.synchronize = self._saved["sync"]
            sharded._send = self._saved["send"]
            sharded._to_shard = self._saved["to_shard"]


def record(fn: Callable, *args, **kwargs):
    """(fn(*args, **kwargs), its op records)."""
    with OpRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.records


# ---------------------------------------------------------------------------
# statistics of an op record
# ---------------------------------------------------------------------------

def op_histogram(records: Iterable[OpRecord]) -> Dict[str, int]:
    """Ops by name."""
    return dict(Counter(r.name for r in records))


def kernel_launches(records: Iterable[OpRecord]) -> Dict[str, int]:
    """Hand-written kernel launches by kernel name."""
    return dict(Counter(r.name.split("::", 1)[1] for r in records
                        if r.name.startswith("kernel::")))


def _copy_ends(r: OpRecord) -> Optional[Tuple[str, str]]:
    """(source device, destination device) of a copy op, else None."""
    if r.name == "aten::_to_copy" and r.inputs and r.outputs:
        return r.inputs[0].device, r.outputs[0].device
    if r.name == "aten::copy_" and len(r.inputs) >= 2:
        return r.inputs[1].device, r.inputs[0].device
    return None


def _collectives(records: Iterable[OpRecord]):
    for r in records:
        if r.name.startswith("collective::"):
            yield r.name.split("::", 1)[1], sum(o.nbytes for o in r.outputs)
            continue
        ends = _copy_ends(r)
        if ends and ends[0] != ends[1] and "cpu" not in ends:
            yield "cross_device_copy", r.inputs[-1].nbytes


def collective_counts(records: Iterable[OpRecord]) -> Dict[str, int]:
    """Collectives by kind ({} when there is none)."""
    return dict(Counter(kind for kind, _ in _collectives(records)))


def collective_bytes(records: Iterable[OpRecord]) -> Dict[str, int]:
    """Bytes of the collectives by kind, and their ``total``."""
    out: Dict[str, int] = {}
    for kind, n in _collectives(records):
        out[kind] = out.get(kind, 0) + n
        out["total"] = out.get("total", 0) + n
    return out


def is_host_sync(r: OpRecord) -> bool:
    if r.name in SYNC_OPS:
        return True
    if r.name == "aten::index" and any(s.dtype == "i1"
                                       for s in r.inputs[1:]):
        return True             # boolean-mask indexing: a nonzero inside
    ends = _copy_ends(r)
    return bool(ends) and ends[0].startswith("cuda") and ends[1] == "cpu"


def host_syncs(records: Iterable[OpRecord]) -> int:
    """Waits of the host for the device (see the module docstring)."""
    return sum(1 for r in records if is_host_sync(r))


def f64_ops(records: Iterable[OpRecord]) -> int:
    """Ops with a float64 input or output."""
    return sum(1 for r in records
               if any(s.dtype == "f64" for s in r.inputs + r.outputs))


# ---------------------------------------------------------------------------
# torch.profiler
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_stats(events: Sequence[dict], wall_us: Optional[float] = None,
                  gaps: int = 5) -> dict:
    """Statistics of a Chrome trace's ``traceEvents`` (what
    ``torch.profiler``'s ``export_chrome_trace`` writes).

    Device work is the complete ("X") events of the kernel, memcpy and
    memset categories. ``device_busy_us`` is the length of their union,
    ``device_busy_share`` its share of ``wall_us`` (the host's clock
    around the run; default the trace's own span). ``idle_gaps_us`` are
    the longest stretches of the trace's span with no device work, the
    span's head and tail included. ``runtime_syncs`` counts the host's
    ``cuda*Synchronize`` calls, ``dtoh_copies`` the device-to-host
    copies, and ``idle_at_syncs_us`` sums the idle stretches in which a
    sync returned: the device drained its queue while the host waited,
    and stays idle until the host enqueues again. ``kernels`` maps kernel
    names to their calls and device ms, the most device time first.
    """
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                 for e in xs if e.get("cat") in DEVICE_CATS)
    if xs:
        t0 = min(float(e["ts"]) for e in xs)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    else:
        t0 = t1 = 0.0
    busy, idle, cur_s, cur_e = 0.0, [], None, t0
    for s, e, _ in dev:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            idle.append((cur_e if cur_s is not None else t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    idle.append((cur_e if cur_s is not None else t0, t1))
    syncs = [float(e["ts"]) + float(e["dur"]) for e in xs
             if e.get("cat") == "cuda_runtime"
             and "Synchronize" in e.get("name", "")]
    at_syncs = [g for g in idle if any(g[0] <= t < g[1] for t in syncs)]
    kern: Dict[str, List[float]] = {}
    for s, e, ev in dev:
        if ev.get("cat") == "kernel":
            k = kern.setdefault(ev["name"], [0, 0.0])
            k[0] += 1
            k[1] += e - s
    rows = sorted(kern.items(), key=lambda kv: -kv[1][1])
    wall = (t1 - t0) if wall_us is None else wall_us
    return {
        "wall_us": wall,
        "device_busy_us": busy,
        "device_busy_share": busy / wall if wall > 0 else 0.0,
        "kernel_launches": sum(v[0] for v in kern.values()),
        "kernels": {name: {"calls": v[0], "device_ms": v[1] / 1e3}
                    for name, v in rows},
        "idle_gaps_us": sorted((b - a for a, b in idle if b > a),
                               reverse=True)[:gaps],
        "idle_us": sum(b - a for a, b in idle),
        "idle_at_syncs_us": sum(b - a for a, b in at_syncs),
        "runtime_syncs": len(syncs),
        "dtoh_copies": sum(1 for e in xs if e.get("cat") == "gpu_memcpy"
                           and "DtoH" in e.get("name", "")),
    }


def profile(fn: Callable[[], object],
            trace_path: Optional[str] = None) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` (CPU and CUDA
    activities), synchronized at both ends, and return
    :func:`profile_stats` of its trace over the host's wall clock. The
    Chrome trace is written to ``trace_path`` when given (else to a
    temporary file, removed)."""
    from torch.profiler import ProfilerActivity, profile as _profile
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)),
                    exist_ok=True)
        path = trace_path
    else:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        if not trace_path:
            os.remove(path)
    return profile_stats(events, wall * 1e6)
