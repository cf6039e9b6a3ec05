"""Hold the port's K1, K5 and K8 against an earlier commit's build of the
same kernels, on the card: K1's and K5's output bits, and every kernel's
device time in turns with the earlier one's.

The earlier sources come from git into a directory the repository
ignores, and are built with the port's own nvcc flags, outside the
package's build directory:

    mkdir -p .experiments/parent
    for f in ln_linear_act.cu ln_linear_act_bwd.cu ppo_loss.cu common.cuh \\
             ln_row.cuh; do
      git show <rev>:ddls_tpu_torch/kernels/csrc/$f > .experiments/parent/$f
    done
    python3 scripts/parent_kernel_check.py --parent .experiments/parent

(``<rev>`` is a commit whose K1 takes no grid arguments, whose K8 takes a
``rowterms`` scratch, and whose K5 has today's entry.) Then:

* K1: every call of ``chip_smoke.py``'s phase-3 serving forwards (both
  buckets of the edge-case batch), of the training fixture's first
  minibatch forward, and fuzzed calls at row counts across every tile
  edge (``models/gnn.py`` ``fwd_grid``), at the update's widths and
  others, in the three forms (plain, gathered with a given right half,
  a zero right half), every activation, with rows whose variance clamps
  at exactly 0: each output bit-equal to the earlier kernel's;
* K5: every call of the fixture's first minibatch step and of the
  edge-case batch's forward and backward (as ``chip_smoke.py``
  ``check_train_kernels`` records them): every output bit-equal;
* device ms (one CUDA graph of 100 calls, ``chip_smoke.device_ms``) of
  K1 over serving's forward and over the update's, K5 and K8 over the
  update's minibatch step: earlier, current, current, earlier;
* K1's device ms over the same calls at other CTA caps of its grid;
* K1's device ms a call, earlier and current in turns, at the update's
  nine widths (random inputs from a seed) and small row counts (SMALL_ROWS:
  device collection's forwards take two graphs).

Prints one JSON line a part and exits 1 when a bit differs.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ddls_tpu_torch import kernels  # noqa: E402
from ddls_tpu_torch.models import gnn  # noqa: E402
from ddls_tpu_torch.rl import ppo  # noqa: E402
from ddls_tpu_torch.rl.fixture import load_train_fixture  # noqa: E402
from ddls_tpu_torch.serve import default_buckets, load_export  # noqa: E402
from ddls_tpu_torch.serve.fixture import (EXPORT_PATH,  # noqa: E402
                                          load_requests)

PARENT_STEMS = ("ln_linear_act", "ln_linear_act_bwd", "ppo_loss")
# the earlier entries' signatures (kernels.KernelSpec's letters)
PARENT_SIGNATURES = {
    "ddls_ln_linear_act": "p" * 8 + "i" * 6 + "p",
    "ddls_ln_linear_act_bwd": "p" * 14 + "i" * 9 + "p",
    "ddls_ppo_loss": "p" * 13 + "i" * 2 + "f" * 6 + "p",
}
# K1's fuzzed calls: the edges of 16-, 32- and 64-row tiles and of the
# grid's tile choice (4,096, 8,192 and 16,384 rows), serving's and the
# update's counts; the update's widths first
FUZZ_ROWS = [1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 1200,
             4095, 4096, 4097, 4864, 8191, 8192, 8193, 16383, 16384, 16385,
             16449, 32768, 65536, 65537]
FUZZ_WIDTHS = [(5, 16), (2, 16), (32, 64), (64, 16), (32, 16), (51, 8),
               (1, 1), (17, 5), (64, 64), (63, 17)]
GRID_CAPS = (132, 256, 264, 512, 1024)
SMALL_ROWS = (8, 76, 300, 1200, 4096)


def build_parent(src: str, out_dir: str):
    """Each earlier source into its own library, all nvcc runs at once;
    returns {C symbol: bound function}."""
    procs = {}
    for stem in PARENT_STEMS:
        lib = os.path.join(out_dir, f"lib{stem}-parent.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib,
               os.path.join(src, f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    fns = {}
    for stem, (proc, lib) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {stem}:\n"
                               f"{output}")
        symbol = f"ddls_{stem}"
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = [kernels._CTYPES[c] for c in PARENT_SIGNATURES[symbol]]
        fn.restype = ctypes.c_int
        fns[symbol] = fn
    return fns


def _call(fn, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier kernel failed to launch: {rc}")


def k1_parent(fns, a, ln_w, ln_b, w, bias, activation, idx=None, b=None,
              b_width=0, **_):
    rows, fa, fb, fo = gnn._check_ln_linear_act(a, ln_w, ln_b, w, bias,
                                                activation, idx, b, b_width)
    out = a.new_empty((rows, fo))
    _call(fns["ddls_ln_linear_act"], a.data_ptr(), kernels.ptr(idx),
          kernels.ptr(b), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
          bias.data_ptr(), out.data_ptr(), rows, fa, fb, int(b is not None),
          fo, gnn._ACTIVATION_CODES[activation])
    return out


def k1_current(a, ln_w, ln_b, w, bias, activation, idx=None, b=None,
               b_width=0, **_):
    return gnn._ln_linear_act_cuda(a, ln_w, ln_b, w, bias, activation, idx,
                                   b, b_width)


def k1_at_cap(cap, a, ln_w, ln_b, w, bias, activation, idx=None, b=None,
              b_width=0, **_):
    """The current K1 over a grid of at most ``cap`` CTAs."""
    rows, fa, fb, fo = gnn._check_ln_linear_act(a, ln_w, ln_b, w, bias,
                                                activation, idx, b, b_width)
    out = a.new_empty((rows, fo))
    blocks, _, tile = gnn._tile_grid(rows, cap)
    _call(kernels._symbol("ln_linear_act"), a.data_ptr(), kernels.ptr(idx),
          kernels.ptr(b), ln_w.data_ptr(), ln_b.data_ptr(), w.data_ptr(),
          bias.data_ptr(), out.data_ptr(), rows, fa, fb, int(b is not None),
          fo, gnn._ACTIVATION_CODES[activation], tile, blocks)
    return out


def k8_parent(fns, logits, values, actions, old_logp, old_values, advs,
              targets, kl_coeff, cfg):
    m, a = logits.shape
    rowterms = logits.new_empty((5, m))
    metrics = logits.new_empty(len(ppo.METRIC_KEYS))
    total = logits.new_empty(())
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    _call(fns["ddls_ppo_loss"], logits.data_ptr(), values.data_ptr(),
          actions.data_ptr(), old_logp.data_ptr(), old_values.data_ptr(),
          advs.data_ptr(), targets.data_ptr(), kl_coeff.data_ptr(),
          rowterms.data_ptr(), metrics.data_ptr(), total.data_ptr(),
          dlogits.data_ptr(), dvalues.data_ptr(), m, a,
          float(1.0 - cfg.clip_param), float(1.0 + cfg.clip_param),
          float(cfg.clip_param), float(cfg.vf_clip_param),
          float(cfg.vf_loss_coeff), float(cfg.entropy_coeff))
    return total, metrics, dlogits, dvalues


@contextlib.contextmanager
def parent_k5(fns):
    """K5's wrapper launching the earlier build (the same C entry)."""
    symbol = "ddls_ln_linear_act_bwd"
    kernels._symbol("ln_linear_act_bwd")  # the current one is loaded
    current = kernels._LOADED[symbol]
    kernels._LOADED[symbol] = fns[symbol]
    try:
        yield
    finally:
        kernels._LOADED[symbol] = current


def same_bits(x, y) -> bool:
    if x is None or y is None:
        return x is None and y is None
    return x.shape == y.shape and torch.equal(x.contiguous().view(
        torch.int32), y.contiguous().view(torch.int32))


def fuzz_k1_calls(device):
    """(args, kwargs) of K1's fuzzed calls, made from a seed."""
    g = torch.Generator().manual_seed(15)
    for rows in FUZZ_ROWS:
        for k_in, fo in FUZZ_WIDTHS:
            for form in ("plain", "gather_concat", "zero_half"):
                if form != "plain" and k_in < 2:
                    continue
                fb = k_in // 2 if form != "plain" else 0
                fa = k_in - fb
                src = max(rows // 3, 1) if form == "gather_concat" else rows
                a = torch.randn(src, fa, generator=g) * 3 + 0.5
                a[0] = 2.0  # a variance tie (when fa == k_in)
                kwargs = {}
                if form == "gather_concat":
                    kwargs = dict(idx=torch.randint(
                        0, src, (rows,), generator=g,
                        dtype=torch.int32).to(device),
                        b=torch.rand(rows, fb, generator=g).to(device))
                elif form == "zero_half":
                    kwargs = dict(b_width=fb)
                params = (torch.randn(k_in, generator=g).to(device),
                          torch.randn(k_in, generator=g).to(device),
                          (torch.randn(fo, k_in, generator=g) / 4).to(device),
                          torch.randn(fo, generator=g).to(device))
                for activation in sorted(gnn.ACTIVATIONS):
                    yield (a.to(device), *params, activation), kwargs


def turns(new, old):
    """Device ms of ``old`` and ``new`` (each a list of calls, summed):
    earlier, current, current, earlier."""
    def total(fns):
        return sum(cs.device_ms(fn) for fn in fns)
    first_old, first_new = total(old), total(new)
    second_new, second_old = total(new), total(old)
    return {"parent_ms": [first_old, second_old],
            "current_ms": [first_new, second_new]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the earlier sources")
    ap.add_argument("--build", default=None,
                    help="where the earlier libraries go (default: a new "
                         "temporary directory)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("parent_kernel_check: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reports = kernels.build(["ln_linear_act", "ln_linear_act_bwd",
                             "ppo_loss"])
    print(json.dumps({"part": "ptxas", **{
        stem: [line.strip() for line in text.splitlines()
               if "registers" in line or "spill" in line]
        for stem, text in reports.items()}}), flush=True)
    fns = build_parent(args.parent, args.build or tempfile.mkdtemp())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    bad = 0

    # K1 on serving's recorded calls, both buckets
    model, params, _ = load_export(EXPORT_PATH)
    requests, _ = load_requests()
    model_gpu = model.to("cuda").eval()
    buckets = default_buckets(cs.PAD_NODES, cs.PAD_EDGES)
    serve_calls = [cs.record_calls(model_gpu, cs.edge_case_batch(
        requests, *bucket))["ln_linear_act"]
        for bucket in (buckets[-1], buckets[0])]
    # the update's forward and its K5 calls
    fx = load_train_fixture()
    cfg = fx["cfg"]
    learner = ppo.PPOLearner(load_export(EXPORT_PATH)[0], cfg,
                             device="cuda")
    state = learner.init_state({k: v.cuda() for k, v in params.items()})
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    batch = learner.minibatch(staged, idx)
    update_calls = cs.record_sites(
        {"ln_linear_act": cs.KERNEL_SITES["ln_linear_act"]},
        lambda: learner.model.flat_batched(batch))["ln_linear_act"]

    def fixture_step():
        advs, targets = learner.flat_advantages(staged)
        learner.loss_and_grads(state, staged, idx, advs, targets)

    with torch.enable_grad():
        step = cs.record_sites(cs.TRAIN_SITES, fixture_step)
        edge = cs.record_sites(cs.TRAIN_SITES, cs._edge_case_train_batch(
            requests, learner.model, cfg))

    k1_sets = {"serve_largest": serve_calls[0],
               "serve_smallest": serve_calls[-1], "update": update_calls}
    held = {}
    for what, calls in k1_sets.items():
        diff = sum(not same_bits(k1_current(*a, **kw),
                                 k1_parent(fns, *a, **kw))
                   for _, a, kw in calls)
        held[what] = {"calls": len(calls), "differing": diff}
        bad += diff
    n_fuzz = diff = 0
    for a, kw in fuzz_k1_calls("cuda"):
        n_fuzz += 1
        diff += not same_bits(k1_current(*a, **kw), k1_parent(fns, *a, **kw))
    held["fuzzed"] = {"calls": n_fuzz, "differing": diff}
    bad += diff
    torch.cuda.synchronize()
    print(json.dumps({"part": "k1_bits", "card": card, **held}), flush=True)

    k5 = {}
    for what, calls in (("step", step), ("edge_case", edge)):
        n = diff = 0
        for fn, a, kw in calls["ln_linear_act_bwd"]:
            with torch.enable_grad():
                current = fn(*a, **kw)
                with parent_k5(fns):
                    earlier = fn(*a, **kw)
            n += 1
            diff += not all(same_bits(x, y) for x, y in zip(current,
                                                            earlier))
        k5[what] = {"calls": n, "differing": diff}
        bad += diff
    torch.cuda.synchronize()
    print(json.dumps({"part": "k5_bits", "card": card, **k5}), flush=True)

    def bound(fn, *a, **kw):
        return lambda: fn(*a, **kw)

    times = {}
    times["k1_serve"] = turns(
        [bound(k1_current, *a, **kw) for _, a, kw in serve_calls[0]],
        [bound(k1_parent, fns, *a, **kw) for _, a, kw in serve_calls[0]])
    times["k1_update"] = turns(
        [bound(k1_current, *a, **kw) for _, a, kw in update_calls],
        [bound(k1_parent, fns, *a, **kw) for _, a, kw in update_calls])
    k5_calls = [bound(fn, *a, **kw) for fn, a, kw in
                step["ln_linear_act_bwd"]]

    def k5_old(call):
        def run():
            with parent_k5(fns):
                return call()
        return run

    times["k5_update"] = turns(k5_calls, [k5_old(c) for c in k5_calls])
    (_, k8_args, _), = step["ppo_loss"]
    times["k8_update"] = turns([bound(ppo._ppo_loss_cuda, *k8_args)],
                               [bound(k8_parent, fns, *k8_args)])
    print(json.dumps({"part": "device_ms", "card": card, **times}),
          flush=True)

    caps = {}
    for cap in GRID_CAPS:
        caps[str(cap)] = {
            what: sum(cs.device_ms(bound(k1_at_cap, cap, *a, **kw))
                      for _, a, kw in calls)
            for what, calls in (("serve", serve_calls[0]),
                                ("update", update_calls))}
    print(json.dumps({"part": "k1_grid_caps", "card": card,
                      "current_cap": gnn._FWD_MAX_BLOCKS, **caps}),
          flush=True)

    # K1 a call at the update's widths and small row counts
    g = torch.Generator().manual_seed(16)
    small = {}
    for rows in SMALL_ROWS:
        for _, a, kw in update_calls:
            w = a[3]
            fa = a[0].shape[1]
            fb = kw["b"].shape[1] if kw.get("b") is not None else \
                kw.get("b_width", 0)
            src = max(rows // 3, 1) if kw.get("idx") is not None else rows
            args = (torch.randn(src, fa, generator=g).cuda(), *a[1:])
            call = {}
            if kw.get("idx") is not None:
                call["idx"] = torch.randint(0, src, (rows,), generator=g,
                                            dtype=torch.int32).cuda()
            if kw.get("b") is not None:
                call["b"] = torch.rand(rows, fb, generator=g).cuda()
            elif fb:
                call["b_width"] = fb
            key = (f"rows={rows} in={fa}+{fb}"
                   f"{' gather' if 'idx' in call else ''} out={w.shape[0]}")
            small[key] = turns([bound(k1_current, *args, **call)],
                               [bound(k1_parent, fns, *args, **call)])
    print(json.dumps({"part": "k1_small_calls", "card": card, **small}),
          flush=True)
    print(json.dumps({"ok": bad == 0, "differing": bad}), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
