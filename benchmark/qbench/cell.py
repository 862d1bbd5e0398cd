"""One run of one cell: set up, warm up, the measured window, the traced
stretch, the comparison with the reference, the result."""

from __future__ import annotations

import gc
import json
import sys
import time
import types

import numpy as np
import torch

from qbench import faults, trace
from qbench.loop import Loop, Spans
from qbench.manifest import Manifest, system_module

WARMUP_BLOCKS = 6          # through the whole loop before the window
TRACE_START = 0.3          # the traced stretch: from this share of the
TRACE_SECONDS = 1.0        # window, this long
FORBIDDEN = ("jax", "jaxlib", "flax", "quisk_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the name before the first dot, compared whole)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def _pinned(blocks: list) -> list:
    out = []
    for b in blocks:
        h = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
        h.copy_(b)
        out.append(h)
    return out


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def run(name: str, seed: int, seconds: float, traced: bool, *,
        t_process: float, device: str = "cuda", manifest: Manifest = None,
        override: dict | None = None, fault: str | None = None) -> dict:
    """The result of one run of cell ``name`` (the contract's last line,
    as a dict).  ``t_process`` is the process's start on the
    ``time.perf_counter`` clock.  ``override`` merges into the
    configuration and ``fault`` plants a fault: both for the CPU tests."""
    man = manifest or Manifest()
    cell = man.workload(name)
    cfg = man.config(cell["config"])
    if override:
        cfg = _merge(cfg, override)
    mix = man.mix(cell["traffic"])
    if mix.get("loop", "closed") != "closed":
        raise ValueError(f"mix {cell['traffic']!r}: only the closed loop")
    cuda = torch.device(device).type == "cuda"
    sysmod = system_module(cfg["system"])

    marks = [("start", t_process), ("imports", time.perf_counter())]
    system = sysmod.System(cfg, seed, device)
    marks.append(("system", time.perf_counter()))
    if fault:
        faults.plant(system, fault)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ring = system.make_ring(mix["ring_blocks"], gen)
    if mix["placement"] == "fed":
        ring = _pinned(ring) if cuda else [b.clone() for b in ring]
    elif mix["placement"] != "resident":
        raise ValueError(f"placement {mix['placement']!r}")
    R = len(ring)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("capture", time.perf_counter()))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    n_check = cfg["check_blocks"]
    loop = Loop(system, ring, mix, device, Spans(traced), keep=n_check)
    in_flight = mix["in_flight"]
    for _ in range(WARMUP_BLOCKS):
        while loop.unfinished() >= in_flight:
            loop.retire(wait=True)
        loop.handoff()
    loop.drain()
    if traced:
        # the profiler's first session pays CUPTI's start-up at its first
        # device activity: pay it here, not in the traced stretch
        warm = _profiler()
        warm.start()
        loop.handoff()
        loop.drain()
        warm.stop()
        del warm
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    log("set-up s: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                                  for a, b in zip(marks, marks[1:])))

    rng = np.random.default_rng([seed, 3])
    samples = sorted(rng.uniform(0.05, 0.9, n_check) * seconds)
    lat: list[float] = []
    attempted = 0
    prof, tr, stopped = None, None, False
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    t_end = t_start + seconds
    t_trace = t_start + TRACE_START * seconds
    done: list[float] = []

    def note(finished):
        for _, t0, t1 in finished:
            if t1 <= t_end:
                lat.append(t1 - t0)
                done.append(t1)

    while True:
        note(loop.retire())
        now = time.perf_counter()
        if traced and prof is None and now >= t_trace:
            prof = _profiler()
            prof.start()
            t_trace = time.perf_counter() + TRACE_SECONDS
        elif prof is not None and not stopped and now >= t_trace:
            prof.stop()
            stopped = True
            now = time.perf_counter()
        if now >= t_end:
            break
        if loop.unfinished() < in_flight:
            keep = bool(samples) and now - t_start >= samples[0]
            if keep:
                samples.pop(0)
            loop.handoff(keep)
            attempted += 1
        else:
            note(loop.retire(wait=True))
    if prof is not None and not stopped:
        prof.stop()
    # draw times that came after the last hand-off (a slow host) take the
    # blocks still unfinished at the close, handed off in the window too
    loop.keep_more = len(samples)
    loop.drain()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    shapes = system.shapes()
    per_block = system.samples_per_block
    kept = {j: [b.numpy().copy() for b in bufs]
            for j, bufs in loop.kept.items()}
    del loop, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise ImportError("loaded after the window: " + ", ".join(found))
    if prof is not None:
        t_tr = time.perf_counter()
        tr = trace.from_profiler(prof)
        log(f"trace read in {time.perf_counter() - t_tr:.3f} s")
        log(f"trace: {len(tr.device)} device activities, {len(tr.spans)} "
            f"spans, {tr.blocks} blocks in {tr.window_ns / 1e9:.4f} s")

    finished = len(lat)
    e2e = {"input_msps": finished * per_block / seconds / 1e6,
           "block_ms_p95": (float(np.percentile(lat, 95)) * 1e3 if lat
                            else float("inf")),
           "setup_s": setup_s}
    log(f"window: {attempted} blocks handed off, {finished} finished in "
        f"{seconds} s; block_ms_p95 over {finished} samples")
    bins = max(1, int(np.ceil(seconds)))
    per_s = np.bincount(np.minimum((np.array(done, dtype=float) - t_start)
                                   .astype(int), bins - 1), minlength=bins)
    log("blocks finished each second: " + " ".join(map(str, per_s)))

    if cuda and mix["placement"] == "fed":
        ring = [b.to(device) for b in ring]     # the reference reads it

    def get_block(j):
        return ring[j % R]

    t_ref = time.perf_counter()
    blocks = sysmod.check(cfg, seed, get_block, R, kept,
                          device if cuda else "cpu")
    log(f"reference: {time.perf_counter() - t_ref:.3f} s for {len(kept)} "
        f"blocks")
    limits = cfg["limits"]
    numbers = {k: max(b[k] for b in blocks.values()) if blocks else
               float("inf") for k in limits}
    wrong = sum(any(b[k] > limits[k] for k in limits)
                for b in blocks.values())
    correct = bool(kept) and wrong == 0
    failed = (n_check - len(kept)) + wrong

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced:
        metrics = {}
        ctx = types.SimpleNamespace(trace=tr, shapes=shapes, cfg=cfg,
                                    mix=mix, cell=cell)
        for m in man.per_layer(name):
            v = man.reader(m["name"])(ctx) if tr is not None else None
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in man.end_to_end(name)}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced and tr is not None:
        dev["busy_s"] = trace.busy_ns(tr) / 1e9
        dev["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = {"device_ops": trace.top_ops(tr),
                               "idle_gaps": trace.idle_by_span(tr)}
    result["device"] = dev
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    log(f"compared {len(kept)} blocks of {n_check} drawn: "
        + ", ".join(str(j) for j in sorted(kept)))
    for k in limits:
        log(f"{k} {numbers[k]!r} limit {limits[k]!r}")
    return result


def dumps(result: dict) -> str:
    return json.dumps(result, separators=(", ", ": "))
