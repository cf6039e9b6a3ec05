"""Drive the PyTorch port (``ddls_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failed phase raises and the script
exits non-zero (nothing is caught):

1. device  — requires CUDA; prints the card, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``; turns TF32 off.
2. build   — compiles the four kernels from ddls_tpu_torch/kernels/csrc
   (one nvcc per source, all at once) and prints the -Xptxas -v summary.
3. kernels — records every kernel call of one forward of the shipped
   policy at the largest bucket (150 nodes, 512 edges) x max_batch 8 and
   at the smallest, on inputs that include nodes with no in-edges, padded
   edges pointing at node 0, a graph with zero real nodes and a fully
   masked action row; holds each kernel against its plain PyTorch version
   (abs and rel 1e-5; K2 and K4 also bitwise across two runs) and times
   the kernel, the plain version and a one-call PyTorch yardstick.
4. serve   — the main path: the shipped ppo_price_mixed export through
   ``build_fleet(device="cuda")`` at max_batch 8 on the default ladder,
   the 64 fixture requests, launch counters reset just before and read
   just after; every answer must be the policy's and equal the recorded
   JAX action, the logits must match the recorded JAX logits within 1e-4,
   batched answers must be bit-equal to one-at-a-time ones, and a
   max_queue=2 pass must answer its overflow from FixedDegreePacking
   without dropping a request.
5. cli     — 8 fixture requests through ``python -m ddls_tpu_torch.serve``.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from ddls_tpu_torch import kernels  # noqa: E402
from ddls_tpu_torch.envs.baselines import FixedDegreePacking  # noqa: E402
from ddls_tpu_torch.envs.obs import pad_obs_to  # noqa: E402
from ddls_tpu_torch.models import gnn as gnn_mod  # noqa: E402
from ddls_tpu_torch.models import policy as policy_mod  # noqa: E402
from ddls_tpu_torch.ops import segment as segment_mod  # noqa: E402
from ddls_tpu_torch.serve import (BucketForward, ObsBucketer,  # noqa: E402
                                  build_fleet, default_buckets, load_export)
from ddls_tpu_torch.serve.fixture import (EXPORT_PATH,  # noqa: E402
                                          load_requests)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# outside the tensor cores; every kernel here is fp32 CUDA-core work
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = 1e-5
MAX_BATCH = 8
PAD_NODES, PAD_EDGES = 150, 512
TIMED_ITERS = 200


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ------------------------------------------------------------------ timing
def eager_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Per-call time of ``fn`` as a caller pays it (host launch cost
    included): CUDA events around ``iters`` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so host
    launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ------------------------------------------- per-kernel plain, yardstick
def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def k1_parts(args, kwargs):
    a, ln_w, ln_b, w, bias, activation = args
    idx, b = kwargs.get("idx"), kwargs.get("b")
    b_width = kwargs.get("b_width", 0)
    rows = idx.shape[0] if idx is not None else a.shape[0]
    k_in, fo = w.shape[1], w.shape[0]
    act = gnn_mod.get_activation(activation)

    def library():
        x = a if idx is None else a[idx.long()]
        x = torch.cat([x, b if b is not None
                       else x.new_zeros((rows, b_width))], dim=1)
        y = torch.nn.functional.layer_norm(x, (k_in,), ln_w, ln_b, eps=1e-6)
        return act(torch.nn.functional.linear(y, w, bias))

    out_bytes = rows * fo * 4
    work = bound_ms(_nbytes(a, idx, b, ln_w, ln_b, w, bias) + out_bytes,
                    rows * (2 * k_in * fo + 8 * k_in + 2 * fo))
    shape = (f"rows={rows} in={a.shape[1]}"
             f"+{b.shape[1] if b is not None else b_width}"
             f"{' gather' if idx is not None else ''} out={fo}")
    return (lambda: gnn_mod.ln_linear_act_plain(*args, **kwargs), library,
            work, shape)


def k2_parts(args, kwargs):
    msg, self_msg, row_ptr, col, node_mask = args
    n_nodes, f = self_msg.shape
    nnz = int(row_ptr[-1])
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(n_nodes, device=msg.device),
                                  deg)
    edges = col[:nnz].long()
    ones = torch.ones(nnz, device=msg.device)

    def library():
        totals = self_msg.new_zeros((n_nodes, f)).index_add_(
            0, dst, msg[edges])
        counts = self_msg.new_zeros(n_nodes).index_add_(0, dst, ones)
        return ((totals + self_msg) / (counts + 1.0)[:, None]
                * node_mask[:, None])

    work = bound_ms(nnz * f * 4 + nnz * 4 + _nbytes(self_msg, row_ptr,
                                                    node_mask)
                    + n_nodes * f * 4, nnz * f + 3 * n_nodes * f)
    return (lambda: segment_mod.csr_segment_mean_plain(*args), library,
            work, f"nodes={n_nodes} edges={nnz} f={f}")


def k3_parts(args, kwargs):
    emb, node_mask, graph_emb = args
    b, n, f = emb.shape
    g = graph_emb.shape[1]

    def library():
        total = (emb * node_mask[..., None]).sum(1)
        count = node_mask.sum(1).clamp(min=1.0)
        return torch.cat([total / count[:, None], graph_emb], 1)

    work = bound_ms(_nbytes(emb, node_mask, graph_emb) + b * (f + g) * 4,
                    2 * b * n * f)
    return (lambda: segment_mod.masked_mean_pool_concat_plain(*args),
            library, work, f"graphs={b} nodes={n} f={f} g={g}")


def k4_parts(args, kwargs):
    logits, mask = args
    rows, a = logits.shape

    def library():
        masked = logits.masked_fill(mask == 0, policy_mod.FLOAT32_MIN)
        return masked, masked.argmax(1)

    work = bound_ms(_nbytes(logits, mask) + rows * a * 4 + rows * 8,
                    3 * rows * a)
    return (lambda: policy_mod.mask_logits_argmax_plain(*args), library,
            work, f"rows={rows} actions={a}")


# (module whose global the forward calls, attribute, parts builder)
KERNEL_SITES = {
    "ln_linear_act": (gnn_mod, "ln_linear_act", k1_parts),
    "csr_segment_mean": (gnn_mod, "csr_segment_mean", k2_parts),
    "masked_mean_pool_concat": (policy_mod, "masked_mean_pool_concat",
                                k3_parts),
    "mask_logits_argmax": (policy_mod, "mask_logits_argmax", k4_parts),
}


def record_calls(model, batch):
    """One forward with every kernel wrapper recorded: {kernel: [(wrapper,
    args, kwargs), ...]} in call order."""
    calls = {name: [] for name in KERNEL_SITES}
    originals = {}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append((fn, args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    for name, (mod, attr, _) in KERNEL_SITES.items():
        originals[name] = getattr(mod, attr)
        setattr(mod, attr, recorder(name, originals[name]))
    try:
        model.flat_batched(batch)
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr, _) in KERNEL_SITES.items():
            setattr(mod, attr, originals[name])
    return calls


def max_err(out, ref) -> float:
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for o, r in zip(outs, refs):
        require(o.shape == r.shape and o.dtype == r.dtype,
                f"kernel output {o.shape}/{o.dtype} vs plain "
                f"{r.shape}/{r.dtype}")
        if o.dtype.is_floating_point:
            require(torch.allclose(o, r, rtol=TOL, atol=TOL),
                    "kernel disagrees with its plain version beyond 1e-5")
            err = max(err, float((o.double() - r.double()).abs().max()))
        else:
            require(torch.equal(o, r), "kernel's integer output differs "
                                       "from its plain version's")
    return err


def edge_case_batch(requests, n_pad, e_pad, device="cuda"):
    """Eight fixture requests padded to (n_pad, e_pad), with slot 6's action
    mask all zero and slot 7 holding a graph with zero real nodes."""
    obs = [pad_obs_to(r, n_pad, e_pad) for r in requests[:MAX_BATCH]]
    obs[6] = dict(obs[6], action_mask=np.zeros_like(obs[6]["action_mask"]))
    obs[7] = pad_obs_to(dict(obs[7], node_split=np.array([0], np.int32),
                             edge_split=np.array([0], np.int32)),
                        n_pad, e_pad)
    stacked = {k: np.stack([o[k] for o in obs]) for k in obs[0]}
    host = policy_mod.prepare_flat_batch(stacked)
    deg = np.diff(host["csr_row_ptr"])
    require(bool(((deg == 0) & (host["node_mask"] == 1)).any()),
            "no real node without in-edges in the edge-case batch")
    require(int(stacked["edge_split"].min()) < e_pad,
            "no padded edges in the edge-case batch")
    return policy_mod.batch_to_device(host, torch.device(device))


def check_kernels(model_gpu, requests):
    """Phase 3: per kernel, max error over both buckets and its times at
    the largest bucket (summed over the calls of one forward)."""
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "eager_ms": 0.0,
                      "plain_ms": 0.0, "library_ms": 0.0,
                      "library_device_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": None, "calls_per_forward": 0,
                      "shapes": []}
               for name in KERNEL_SITES}
    buckets = default_buckets(PAD_NODES, PAD_EDGES)
    for timed, (n_pad, e_pad) in ((True, buckets[-1]), (False, buckets[0])):
        batch = edge_case_batch(requests, n_pad, e_pad)
        calls = record_calls(model_gpu, batch)
        for name, recorded in calls.items():
            require(len(recorded) > 0, f"forward made no {name} call")
            res = results[name]
            parts = KERNEL_SITES[name][2]
            bound_total = {"bytes": 0.0, "operations": 0.0}
            for fn, args, kwargs in recorded:
                plain, library, (bound, bound_by), shape = parts(args,
                                                                 kwargs)
                out = fn(*args, **kwargs)
                ref = plain()
                torch.cuda.synchronize()
                res["max_abs_err"] = max(res["max_abs_err"],
                                         max_err(out, ref))
                if name in ("csr_segment_mean", "mask_logits_argmax"):
                    again = fn(*args, **kwargs)
                    outs = out if isinstance(out, tuple) else (out,)
                    agains = again if isinstance(again, tuple) else (again,)
                    require(all(torch.equal(x, y)
                                for x, y in zip(outs, agains)),
                            f"{name} is not bitwise repeatable")
                if not timed:
                    continue
                res["calls_per_forward"] += 1
                res["shapes"].append(shape)
                res["ms"] += device_ms(lambda: fn(*args, **kwargs))
                res["eager_ms"] += eager_ms(lambda: fn(*args, **kwargs))
                res["plain_ms"] += eager_ms(plain, iters=20)
                res["library_ms"] += eager_ms(library)
                res["library_device_ms"] += device_ms(library)
                res["bound_ms"] += bound
                bound_total[bound_by] += bound
            if timed:
                res["bound_by"] = max(bound_total, key=bound_total.get)
    return results


# ------------------------------------------------------------------ phases
def phase_device():
    require(torch.cuda.is_available(), "CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return kind, smi


def phase_build():
    t0 = time.monotonic()
    reports = kernels.build()
    seconds = time.monotonic() - t0
    summary = {name: [ln.strip() for ln in text.splitlines()
                      if "Used" in ln or "spill" in ln]
               for name, text in reports.items()}
    emit("build", seconds=seconds, built=sorted(reports),
         nvcc=kernels.nvcc_path(), ptxas=summary)


def phase_serve(model, params, requests, recorded, card):
    buckets = default_buckets(PAD_NODES, PAD_EDGES)
    fleet = build_fleet(model, params, device="cuda", buckets=buckets,
                        max_batch=MAX_BATCH, max_queue=len(requests),
                        deadline_s=0.002)
    server = fleet.replica_set.replicas[0].server
    # warm-up: one flush per bucket shape the fixture reaches (library
    # loads, allocator), outside the measured run
    for obs in requests[:MAX_BATCH]:
        fleet.submit(obs)
    fleet.drain()
    fleet.reset_stats()
    server = fleet.replica_set.replicas[0].server

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    ids, responses = [], []
    for obs in requests:
        ids.append(fleet.submit(obs))
        responses += fleet.poll()
    responses += fleet.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()

    by_id = {r.request_id: r for r in responses}
    require(sorted(by_id) == sorted(ids), "a request was dropped")
    require(all(r.source == "policy" for r in responses),
            f"non-policy answers: {[(r.source, r.reason) for r in responses if r.source != 'policy']}")
    require(not any(r.reason in ("degraded", "invalid") for r in responses),
            "degraded or invalid answers")
    require(not server.degraded, "the server latched degraded mode")
    actions = np.array([by_id[i].action for i in ids])
    require(np.array_equal(actions, recorded["jax_actions"]),
            "served actions differ from the recorded JAX actions")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    summary = server.stats.summary()

    # logits on the same program shapes: batched forward vs the recorded
    # JAX logits, and batched vs one-at-a-time bit-equality
    forward = BucketForward(model, params, MAX_BATCH, device="cuda")
    bucketer = ObsBucketer(buckets)
    padded = [bucketer.bucket_obs(o) for o in requests]
    groups = {}
    for i, (idx, _) in enumerate(padded):
        groups.setdefault(idx, []).append(i)
    logits = np.zeros_like(recorded["jax_logits"])
    values = np.zeros_like(recorded["jax_values"])
    stack_s = run_s = 0.0
    n_batches = 0
    for members in groups.values():
        for start in range(0, len(members), MAX_BATCH):
            chunk = members[start:start + MAX_BATCH]
            t0 = time.monotonic()
            staged, n_real = forward.stack([padded[i][1] for i in chunk])
            t1 = time.monotonic()
            lo, va, ac = forward.run(staged, n_real)
            stack_s += t1 - t0
            run_s += time.monotonic() - t1
            n_batches += 1
            logits[chunk], values[chunk] = lo, va
            for k, i in enumerate(chunk):
                lo1, va1, ac1 = forward.forward([padded[i][1]])
                require(np.array_equal(lo1[0], lo[k])
                        and np.array_equal(va1[0], va[k])
                        and ac1[0] == ac[k],
                        f"request {i}: batched answer differs from the "
                        f"one-at-a-time answer")
    masked = recorded["jax_logits"] == np.finfo(np.float32).min
    require(np.array_equal(logits[masked], recorded["jax_logits"][masked]),
            "masked logits differ from the JAX ones")
    logit_err = float(np.abs(logits - recorded["jax_logits"]).max())
    value_err = float(np.abs(values - recorded["jax_values"]).max())
    require(logit_err <= 1e-4 and value_err <= 1e-4,
            f"logits/values off the JAX reference: {logit_err}, "
            f"{value_err}")

    # saturation: a 2-deep queue answers the overflow from the heuristic
    sat = build_fleet(model, params, device="cuda", buckets=buckets,
                      max_batch=MAX_BATCH, max_queue=2, deadline_s=10.0)
    sat_ids = [sat.submit(o) for o in requests]
    sat_resp = sat.poll() + sat.drain()
    rule = FixedDegreePacking(degree=8)
    fallback = [r for r in sat_resp if r.source == "fallback"]
    require(sorted(r.request_id for r in sat_resp) == sorted(sat_ids),
            "the saturation pass dropped a request")
    require(len(fallback) == len(requests) - 2
            and all(r.reason == "saturated"
                    and r.action == rule.compute_action(
                        requests[r.request_id]) for r in fallback),
            "saturation overflow was not answered by FixedDegreePacking")
    require(not any(r.reason in ("degraded", "invalid") for r in sat_resp),
            "degraded or invalid answers in the saturation pass")

    profiled = profile_serve(model, params, buckets, requests)

    emit("serve", card=card, n_requests=len(requests),
         requests_per_s=len(requests) / wall, wall_s=wall,
         host_stack_ms_per_flush=stack_s / n_batches * 1e3,
         run_ms_per_flush=run_s / n_batches * 1e3, profiled=profiled,
         p50_latency_ms=summary["p50_latency_ms"],
         p99_latency_ms=summary["p99_latency_ms"],
         n_flushes=summary["n_flushes"], program_shapes=summary["n_compiles"],
         launches=launches, logit_max_abs_err=logit_err,
         value_max_abs_err=value_err,
         saturation_fallbacks=len(fallback))
    return launches


def profile_serve(model, params, buckets, requests):
    """One more pass of the requests through a warmed fleet under
    torch.profiler: the card's kernel and copy time over the pass's wall
    time (the profiler's own host cost is inside that wall, so the busy
    share is a lower bound), and the largest device-time totals by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fleet = build_fleet(model, params, device="cuda", buckets=buckets,
                        max_batch=MAX_BATCH, max_queue=len(requests),
                        deadline_s=0.002)
    for obs in requests[:MAX_BATCH]:
        fleet.submit(obs)
    fleet.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for obs in requests:
            fleet.submit(obs)
            fleet.poll()
        fleet.drain()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.device_time_total / 1e3)
    device_ms = sum(by_name.values())
    copy_ms = sum(v for k, v in by_name.items()
                  if k.startswith(("Memcpy", "Memset")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "copy_ms": copy_ms, "device_busy_share": device_ms / wall_ms,
            "device_events": len(by_name),
            "top_device_ms": {k[:80]: v for k, v in top}}


def phase_cli(requests, recorded):
    lines = "".join(json.dumps({"id": f"req-{i}", "obs": {
        k: np.asarray(v).tolist() for k, v in requests[i].items()}}) + "\n"
        for i in range(MAX_BATCH))
    proc = subprocess.run(
        [sys.executable, "-m", "ddls_tpu_torch.serve", "--params",
         EXPORT_PATH, "--deadline-ms", "5"], input=lines,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    require(proc.returncode == 0, f"CLI exited {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    answers = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    require(len(answers) == MAX_BATCH, f"CLI answered {len(answers)} of "
                                       f"{MAX_BATCH} requests")
    got = {a["id"]: a for a in answers}
    for i in range(MAX_BATCH):
        a = got.get(f"req-{i}")
        require(a is not None and a["source"] == "policy"
                and a["action"] == int(recorded["jax_actions"][i]),
                f"CLI answer for req-{i}: {a}")
    emit("cli", n_requests=MAX_BATCH,
         stats=json.loads(proc.stderr.strip().splitlines()[-1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    kind, card = phase_device()
    phase_build()

    model, params, _ = load_export(EXPORT_PATH)
    requests, recorded = load_requests()
    model_gpu = copy.deepcopy(model).to("cuda").eval()
    results = check_kernels(model_gpu, requests)
    emit("kernels_checked", card=card,
         **{name: {k: v for k, v in r.items() if k != "shapes"}
            for name, r in results.items()})

    launches = phase_serve(model, params, requests, recorded, card)
    phase_cli(requests, recorded)

    rows = []
    for name, r in results.items():
        spec = kernels.KERNELS[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(spec.source, REPO),
            "replaces": spec.replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "eager_ms": r["eager_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "calls_per_forward": r["calls_per_forward"],
            "shapes": r["shapes"], "card": card})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
