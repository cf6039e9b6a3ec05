"""Hold the port's kernels against an earlier commit's build of the same
kernels, on the card: their output bits, and their device time in turns
with the earlier ones'. Four sets (``--kernels``):

* ``k1k5k8``: K1, K5 and K8 against a build whose K1 takes no grid
  arguments, whose K8 takes a ``rowterms`` scratch and whose K5 has
  today's entry;
* ``k18k19``: K18 and K19 (one launch each) against a build of their
  two- and three-launch entries (``mlp_heads_bwd`` with
  ``mlp_heads_bwd_reduce``; ``clip_adam_norm``, ``clip_adam_reduce`` and
  ``clip_adam_update`` over a device leaf table);
* ``k6k17k23``: K6's three entries, K17 and K23 against a build whose
  K6 mean and pooling backwards take no ``force`` argument (a thread per
  element, a block per graph; its CSR sum, a warp per node, is today's),
  whose K17 takes no tile (16-row tiles) and whose K23
  takes no forced form (its tables always in shared memory);
* ``k2k20``: K2 and K20 against a build whose K2 runs a warp a node with
  the edge loop inside the feature loop and whose K20 has every CTA of
  256 threads sum the nnz of all samples before it copies, 4 bytes at a
  time (the same entries as today's).

The earlier sources come from git into a directory the repository
ignores, and are built with the port's own nvcc flags, outside the
package's build directory:

    mkdir -p .experiments/parent
    for f in mlp_heads.cu clip_adam.cu common.cuh ln_row.cuh; do
      git show <rev>:ddls_tpu_torch/kernels/csrc/$f > .experiments/parent/$f
    done
    python3 scripts/parent_kernel_check.py --kernels k18k19 \\
        --parent .experiments/parent

(for ``k1k5k8``: ``ln_linear_act.cu ln_linear_act_bwd.cu ppo_loss.cu
common.cuh ln_row.cuh``; for ``k6k17k23``: ``segment_bwd.cu mlp_heads.cu
placement.cu common.cuh ln_row.cuh cluster.cuh``; for ``k2k20``:
``csr_segment_mean.cu minibatch_gather.cu common.cuh``). With ``k2k20``:

* K2: both calls of the training fixture's first minibatch forward (4,864
  nodes at widths 64 and 16), every call of a serving forward of the
  edge-case batch at both buckets, and fuzzed CSR batches at the
  update's (128 graphs of 38 nodes and 128 edges) and serving's (8 of 150
  and 512) shapes at widths 1, 3, 4, 5, 16, 17, 64 and 128, with the
  messages also misaligned: every output bit-equal;
* K20: the training fixture's samples staged at the (38, 128) bucket and
  at (150, 512): 1 sample, 128 with repeats, 512 with repeats (the Ape-X
  DQN's minibatch), 2 (a device-collection step's lanes), the full batch
  in row order and 1,024, 2,048 and 4,000 with repeats: every array
  equal;
* device ms in turns: K2's two calls at the update, each alone, and a
  serving forward's calls; K20 at 1, 128, 512, 1,024, 2,048 and 4,000
  rows at (38, 128) and at a device-collection step's 2 lanes at
  (150, 512); a whole
  minibatch step with the earlier K2 and K20 swapped into the wrappers
  (device time and device operations a step).

With ``k6k17k23``:

* K6: every call of the training fixture's first minibatch backward and
  fuzzed CSR batches at the update's (128 graphs of 38 nodes and 128
  edges) and serving's (8 of 150 and 512) shapes at widths 1, 3, 4, 16,
  17 and 64, on misaligned inputs too: every output bit-equal;
* K17: 1 to 4,000 rows on the shipped heads, the Ape-X DQN's and the
  default (256, 256) ones, and the fixture's minibatch forward: bit-equal;
* K23, both entries, float32 and float64, at 1, 8 and 72 rows of fuzzed
  states on the 32-, 64- and 128-server surfaces, in the shared form and
  with the tables' global form forced: bit-equal to the earlier shared
  form;
* device ms in turns: K6's entries and K17 over the fixture's minibatch
  step, K17 at a serving batch, at the Ape-X DQN's 32 and 512 rows, the
  default heads' 128 and the shipped heads' 4,000, K23 on the replay's
  first decision (8
  lanes) and on 72 indexed rows, and a whole minibatch step with the
  earlier K6 and K17 swapped into the wrappers (device time and device
  operations a step).

With ``k18k19``:

* K18: every row count of the card tests (1 to 4,000) on the shipped
  heads, the Ape-X DQN's 256-wide ones and the default (256, 256) ones,
  and the training fixture's first minibatch backward: dx and every
  gradient bit-equal to the earlier build's;
* K19: four steps of adam, rmsprop and rmsprop with momentum from the
  same states, at the clip tie and with the clip firing, on the shipped
  policy's leaves and DQN-sized ones: params, mu and nu bit-equal;
* device ms in turns (earlier, current, current, earlier): K18 at the
  update's 128 rows, at 512 DQN rows and at 4,000 rows; K19 over the
  shipped policy's leaves; a whole minibatch step of the fixture
  (``chip_smoke.profile_steps``: device time and device operations a
  step) with the earlier K18 and K19 swapped into the wrappers.

With ``k1k5k8``:

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

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ddls_tpu_torch import kernels  # noqa: E402
from ddls_tpu_torch.models import gnn, policy  # noqa: E402
from ddls_tpu_torch.rl import learner as learner_mod  # noqa: E402
from ddls_tpu_torch.rl import ppo  # noqa: E402
from ddls_tpu_torch.rl.fixture import load_train_fixture  # noqa: E402
from ddls_tpu_torch.serve import default_buckets, load_export  # noqa: E402
from ddls_tpu_torch.serve.fixture import (EXPORT_PATH,  # noqa: E402
                                          load_requests)

# the earlier sources and entries of each set (kernels.KernelSpec's
# signature letters)
PARENTS = {
    "k1k5k8": {
        "ln_linear_act": {"ddls_ln_linear_act": "p" * 8 + "i" * 6 + "p"},
        "ln_linear_act_bwd": {
            "ddls_ln_linear_act_bwd": "p" * 14 + "i" * 9 + "p"},
        "ppo_loss": {"ddls_ppo_loss": "p" * 13 + "i" * 2 + "f" * 6 + "p"},
    },
    "k6k17k23": {
        "segment_bwd": {"ddls_csr_segment_mean_bwd": "ppppppiiip",
                        "ddls_csr_segment_sum": "ppppiip",
                        "ddls_masked_mean_pool_concat_bwd": "ppppiiiip"},
        "mlp_heads": {"ddls_mlp_heads": "ppppiip"},
        "placement": {"ddls_allocate_job": "p" * 17 + "i" * 11 + "p"},
    },
    "k2k20": {
        "csr_segment_mean": {"ddls_csr_segment_mean": "ppppppiip"},
        "minibatch_gather": {"ddls_minibatch_gather": "p" * 18 + "i" * 7
                             + "p"},
    },
    "k18k19": {
        "mlp_heads": {"ddls_mlp_heads_bwd": "ppppppiiip",
                      "ddls_mlp_heads_bwd_reduce": "ppiip"},
        "clip_adam": {"ddls_clip_adam_norm": "pppiip",
                      "ddls_clip_adam_reduce": "ppip",
                      "ddls_clip_adam_update": "pppiiifffffffffp"},
    },
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


def build_parent(src: str, out_dir: str, parents):
    """Each earlier source into its own library, all nvcc runs at once;
    returns {C symbol: bound function}."""
    procs = {}
    for stem in parents:
        lib = os.path.join(out_dir, f"lib{stem}-parent.so")
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
               *kernels.EXTRA_FLAGS.get(stem, ()), "-o", lib,
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
        for symbol, signature in parents[stem].items():
            fn = getattr(ctypes.CDLL(lib), symbol)
            fn.argtypes = [kernels._CTYPES[c] for c in signature]
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


def check_k1_k5_k8(fns, card) -> int:
    """K1's and K5's bits and K1's, K5's and K8's device ms against the
    earlier build; returns the count of differing calls."""
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
    return bad


# ------------------------------------------------------------ K18, K19
def k18_parent(fns, x, logit_layers, value_layers, activation, dlogits,
               dvalue):
    """The earlier K18: its kernel into per-CTA rows, then its reduce
    launch (``policy.mlp_heads_bwd``'s result)."""
    table, n_params = policy._heads_table(x, logit_layers, value_layers,
                                          activation)
    rows = x.shape[0]
    dx = x.new_empty(x.shape)
    blocks = max(1, min(-(-rows // 8), 132))
    partial = x.new_empty((blocks, n_params))
    _call(fns["ddls_mlp_heads_bwd"], x.data_ptr(), ctypes.addressof(table),
          dlogits.data_ptr(), dvalue.data_ptr(), dx.data_ptr(),
          partial.data_ptr(), rows, policy._ACTIVATION_CODES[activation],
          blocks)
    grads = x.new_empty(n_params)
    _call(fns["ddls_mlp_heads_bwd_reduce"], partial.data_ptr(),
          grads.data_ptr(), blocks, n_params)
    out, at = [], 0
    for w, b in logit_layers + value_layers:
        out.append(grads[at:at + w.numel()].view(w.shape))
        at += w.numel()
        out.append(grads[at:at + b.numel()])
        at += b.numel()
    return dx, out


class ParentK19:
    """The earlier K19's three launches over a device leaf table built
    once per train state (as its wrapper cached it)."""

    def __init__(self, fns):
        self.fns = fns
        self.tables = {}

    def __call__(self, state, grads, hp):
        n = len(state.params)
        mu = state.mu or [None] * n
        key = tuple(t.data_ptr() if t is not None else 0
                    for t in (*state.params, *mu, *state.nu))
        if key not in self.tables:
            sizes = [p.numel() for p in state.params]
            self.tables[key] = (
                torch.tensor(list(key) + sizes, dtype=torch.int64,
                             device=state.params[0].device),
                max(1, -(-max(sizes) // 1024)))
        table, chunks = self.tables[key]
        grad_table = (ctypes.c_int64 * n)(*(g.data_ptr() for g in grads))
        norm = None
        if hp.grad_clip is not None:
            partial = state.params[0].new_empty(n * chunks)
            norm = state.params[0].new_empty(1)
            _call(self.fns["ddls_clip_adam_norm"],
                  ctypes.addressof(grad_table), table.data_ptr(),
                  partial.data_ptr(), n, chunks)
            _call(self.fns["ddls_clip_adam_reduce"], partial.data_ptr(),
                  norm.data_ptr(), partial.numel())
        f32 = np.float32
        _call(self.fns["ddls_clip_adam_update"], ctypes.addressof(grad_table),
              table.data_ptr(), kernels.ptr(norm), n, chunks,
              learner_mod._OPT_RULES[hp.rule], float(hp.grad_clip or 0.0),
              hp.lr, hp.b1, float(f32(1.0 - hp.b1)), hp.b2,
              float(f32(1.0 - hp.b2)), hp.eps, hp.bc1, hp.bc2)


@contextlib.contextmanager
def swapped(k18, k19):
    """The wrappers' K18 and K19 replaced (the autograd function and the
    learners call them through their modules)."""
    saved = policy.mlp_heads_bwd, learner_mod.clip_adam
    policy.mlp_heads_bwd, learner_mod.clip_adam = k18, k19
    try:
        yield
    finally:
        policy.mlp_heads_bwd, learner_mod.clip_adam = saved


def _heads(hiddens, seed):
    g = torch.Generator().manual_seed(seed)
    out = []
    for final in (17, 1):
        widths = [24, *hiddens, final]
        out.append([((torch.randn(widths[i + 1], widths[i], generator=g)
                      / widths[i] ** 0.5).cuda(),
                     (torch.randn(widths[i + 1], generator=g) * 0.1).cuda())
                    for i in range(len(widths) - 1)])
    return out


def _k19_leaves(sizes, rule, seed):
    g = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=g).cuda() for s in sizes]
    return learner_mod.TrainState(
        names=[str(i) for i in range(len(sizes))], params=params,
        mu=None if rule == "rmsprop" else [torch.zeros_like(p)
                                           for p in params],
        nu=[torch.zeros_like(p) for p in params]), g


def check_k18_k19(fns, card) -> int:
    """K18's and K19's bits against the earlier build, their device ms and
    a minibatch step's in turns; returns the count of differing calls."""
    import dataclasses

    bad = 0
    held = {}
    g = torch.Generator().manual_seed(18)
    for name, hiddens in (("shipped", (17,)), ("dqn", (256,)),
                          ("default", (256, 256))):
        lh, vh = _heads(hiddens, len(hiddens))
        n = diff = 0
        for rows in (1, 7, 8, 128, 500, 512, 1056, 1057, 4000):
            args = (torch.randn(rows, 24, generator=g).cuda(), lh, vh,
                    "relu", torch.randn(rows, 17, generator=g).cuda(),
                    torch.randn(rows, generator=g).cuda())
            got = policy.mlp_heads_bwd(*args)
            want = k18_parent(fns, *args)
            n += 1
            diff += not all(same_bits(a, b) for a, b in
                            zip([got[0], *got[1]], [want[0], *want[1]]))
        held[name] = {"calls": n, "differing": diff}
        bad += diff
    # the fixture's first minibatch backward (the update's shapes)
    fx = load_train_fixture()
    cfg = fx["cfg"]
    model, params, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, cfg, device="cuda")
    gpu_params = {k: v.cuda() for k, v in params.items()}
    state = learner.init_state(gpu_params)
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    batch = learner.minibatch(staged, idx)
    (_, heads_args, _), = cs.record_sites(
        {"mlp_heads": (policy, "mlp_heads", cs.k17_parts)},
        lambda: learner.model.flat_batched(batch))["mlp_heads"]
    x = heads_args[0]
    update_args = (*heads_args, torch.randn(x.shape[0], 17, generator=g
                                            ).cuda(),
                   torch.randn(x.shape[0], generator=g).cuda())
    got, want = policy.mlp_heads_bwd(*update_args), k18_parent(
        fns, *update_args)
    diff = not all(same_bits(a, b) for a, b in
                   zip([got[0], *got[1]], [want[0], *want[1]]))
    held["update"] = {"calls": 1, "differing": int(diff)}
    bad += diff

    parent_k19 = ParentK19(fns)
    shipped_sizes = [p.numel() for p in state.params]
    dqn_sizes = [256 * 24, 256, 17 * 256, 17, 256 * 24, 256, 256, 1, 3000]
    for rule in ("adam", "rmsprop", "rmsprop_momentum"):
        for what, sizes in (("shipped", shipped_sizes), ("dqn", dqn_sizes)):
            n = diff = 0
            for seed in range(2):
                runs = []
                for fn in (learner_mod.clip_adam, parent_k19):
                    st, gen = _k19_leaves(sizes, rule, seed)
                    for step in range(1, 5):
                        grads = [torch.randn(p.shape, generator=gen).cuda()
                                 for p in st.params]
                        norm = float(torch.sqrt(sum(
                            (t.double() ** 2).sum() for t in grads)))
                        clip = float(np.float32(norm)) if step % 2 else 0.5
                        hp = (learner_mod.OptimizerStep(
                            "adam", 1e-3, clip, 0.9, 0.999, 1e-8,
                            1 - 0.9 ** step, 1 - 0.999 ** step)
                              if rule == "adam" else
                              learner_mod.OptimizerStep(rule, 1e-3, clip,
                                                        0.5, 0.99, 0.1))
                        fn(st, grads, hp)
                    runs.append(st.params + (st.mu or []) + st.nu)
                n += 1
                diff += not all(same_bits(a, b) for a, b in zip(*runs))
            held[f"k19_{rule}_{what}"] = {"calls": n, "differing": diff}
            bad += diff
    torch.cuda.synchronize()
    print(json.dumps({"part": "k18_k19_bits", "card": card, **held}),
          flush=True)

    def bound(fn, *a, **kw):
        return lambda: fn(*a, **kw)

    times = {"k18_update": turns(
        [bound(policy.mlp_heads_bwd, *update_args)],
        [bound(k18_parent, fns, *update_args)])}
    for name, hiddens, rows in (("k18_dqn_512", (256,), 512),
                                ("k18_shipped_4000", (17,), 4000)):
        lh, vh = _heads(hiddens, 7)
        a = (torch.randn(rows, 24, generator=g).cuda(), lh, vh, "relu",
             torch.randn(rows, 17, generator=g).cuda(),
             torch.randn(rows, generator=g).cuda())
        times[name] = turns([bound(policy.mlp_heads_bwd, *a)],
                            [bound(k18_parent, fns, *a)])
    hp = learner_mod.OptimizerStep(
        "adam", cfg.lr, cfg.grad_clip, learner_mod.ADAM_B1,
        learner_mod.ADAM_B2, learner_mod.ADAM_EPS,
        learner._bias_correction(learner_mod.ADAM_B1, 1),
        learner._bias_correction(learner_mod.ADAM_B2, 1))
    k19_grads = [torch.randn(p.shape, generator=g).cuda()
                 for p in state.params]
    cur_state = learner.init_state(gpu_params)
    old_state = learner.init_state(gpu_params)
    times["k19_update"] = turns(
        [bound(learner_mod.clip_adam, cur_state, k19_grads, hp)],
        [bound(parent_k19, old_state, k19_grads, hp)])
    dqn_state, _ = _k19_leaves(dqn_sizes, "adam", 0)
    dqn_old, _ = _k19_leaves(dqn_sizes, "adam", 0)
    dqn_grads = [torch.randn(p.shape, generator=g).cuda()
                 for p in dqn_state.params]
    times["k19_dqn"] = turns(
        [bound(learner_mod.clip_adam, dqn_state, dqn_grads, hp)],
        [bound(parent_k19, dqn_old, dqn_grads, hp)])
    print(json.dumps({"part": "device_ms", "card": card, **times}),
          flush=True)

    # a whole minibatch step, the earlier K18 and K19 swapped in
    perm0 = torch.as_tensor(fx["runs"][50]["perms"][0], device="cuda")

    def step_profile(old):
        st = learner.init_state(gpu_params)
        with torch.enable_grad():
            if old:
                with swapped(lambda *a: k18_parent(fns, *a), parent_k19):
                    return cs.profile_steps(learner, staged, st, perm0,
                                            n_steps=16)
            return cs.profile_steps(learner, staged, st, perm0, n_steps=16)

    keys = ("device_ms_per_step", "device_events_per_step", "wall_ms",
            "device_busy_share")
    steps = {}
    for label, old in (("parent", True), ("current", False),
                       ("current_again", False), ("parent_again", True)):
        prof = step_profile(old)
        steps[label] = {k: prof[k] for k in keys}
    print(json.dumps({"part": "minibatch_step", "card": card, **steps}),
          flush=True)
    return bad


# ------------------------------------------------------- K6, K17, K23
# each current entry's arguments past the earlier entry's, just before the
# stream: K6's plan (vec, group), K17's tile, K23's forced form
EXTRA_ARGS = {"ddls_csr_segment_mean_bwd": 1, "ddls_csr_segment_sum": 0,
              "ddls_masked_mean_pool_concat_bwd": 1, "ddls_mlp_heads": 1,
              "ddls_allocate_job": 1, "ddls_csr_segment_mean": 0,
              "ddls_minibatch_gather": 0}
K6_WIDTHS = (1, 3, 4, 16, 17, 64)
K17_ROWS = (1, 7, 8, 16, 17, 128, 500, 4000)


@contextlib.contextmanager
def parent_entries(fns, symbols):
    """The wrappers' launches of ``symbols`` go to the earlier build: each
    current entry is replaced by a shim that drops the arguments the
    earlier entry does not take."""
    saved = {}
    for symbol in symbols:
        name = next(k for k, spec in kernels.KERNELS.items()
                    if spec.symbol == symbol)
        kernels._symbol(name)  # the current one is loaded
        saved[symbol] = kernels._LOADED[symbol]
        drop, parent = EXTRA_ARGS[symbol], fns[symbol]
        kernels._LOADED[symbol] = (
            lambda *a, _p=parent, _d=drop: _p(*a[:-1 - _d], a[-1]))
    try:
        yield
    finally:
        kernels._LOADED.update(saved)


def _both(fns, symbols, call):
    """``call()`` through the current build, then the earlier one."""
    current = call()
    with parent_entries(fns, symbols):
        earlier = call()
    return current, earlier


def _flat_out(out):
    if isinstance(out, torch.Tensor):
        return [out]
    flat = []
    for o in out:
        flat.extend(_flat_out(o) if not isinstance(o, torch.Tensor) else [o])
    return flat


def _same_outputs(a, b) -> bool:
    return all(same_bits(x, y) for x, y in zip(_flat_out(a), _flat_out(b)))


def _misaligned(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def fuzz_k6_calls(device):
    """(entry name, args) of K6's fuzzed calls: random CSR batches at the
    update's and serving's shapes, every width of ``K6_WIDTHS``, the
    first input also misaligned."""
    from ddls_tpu_torch.ops import segment

    rng = np.random.default_rng(17)
    for graphs, n, e in ((128, 38, 128), (8, 150, 512)):
        n_real = rng.integers(0, n + 1, graphs)
        n_real[-1] = 0
        dst = np.zeros(graphs * e, np.int64)
        mask = np.zeros(graphs * e, bool)
        for b in range(graphs):
            m = int(rng.integers(0, e + 1)) if n_real[b] else 0
            dst[b * e:b * e + m] = b * n + rng.integers(0, n_real[b] or 1, m)
            mask[b * e:b * e + m] = True
        node_mask = (np.arange(n)[None] < n_real[:, None]).reshape(-1)
        row_ptr, col = segment.build_csr(dst, mask, graphs * n)
        edge_dst = np.where(mask, dst, -1).astype(np.int32)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        rp, cl, nm, ed = (t(row_ptr), t(col), t(node_mask.astype(np.float32)),
                          t(edge_dst))
        for f in K6_WIDTHS:
            dout = torch.from_numpy(rng.normal(size=(graphs * n, f)).astype(
                np.float32)).to(device)
            g = torch.from_numpy(rng.normal(size=(graphs * e, f)).astype(
                np.float32)).to(device)
            pool = torch.from_numpy(rng.normal(size=(graphs, f + 8)).astype(
                np.float32)).to(device)
            for first in (lambda x: x, _misaligned):
                yield "csr_segment_mean_bwd", (first(dout), rp, ed, nm)
                yield "csr_segment_sum", (first(g), rp, cl)
                yield "masked_mean_pool_concat_bwd", (
                    first(pool), nm.view(graphs, n), f)


def _k23_cases(device):
    """(what, tables, dev, args) of K23's fuzzed calls on the 32-, 64- and
    128-server surfaces."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
    from ddls_tpu_torch.sim import device_env
    from ddls_tpu_torch.sim import fixture as dfx

    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    for tables in (et, dfx.multi_word_tables(et), dfx.wide_episode_tables(8)):
        for dtype in (torch.float32, torch.float64):
            dev = device_env.device_tables(tables, device, dtype)
            for rows in (1, 8, 72):
                for indexed in (False, True):
                    for seed in range(2):
                        yield (f"servers={tables.n_srv} {str(dtype)[6:]}",
                               dev, dfx.fuzzed_placements(
                                   tables, dev, rows, seed, indexed))


def check_k6_k17_k23(fns, card) -> int:
    """K6's, K17's and K23's bits against the earlier build, their device
    ms and a minibatch step's in turns; returns the count of differing
    calls."""
    from ddls_tpu_torch.ops import segment
    from ddls_tpu_torch.sim import device_env

    k6 = ("ddls_csr_segment_mean_bwd", "ddls_csr_segment_sum",
          "ddls_masked_mean_pool_concat_bwd")
    k17 = ("ddls_mlp_heads",)
    k23 = ("ddls_allocate_job",)
    bad = 0
    held = {}
    # K6 on the fixture's first minibatch step and fuzzed batches
    fx = load_train_fixture()
    cfg = fx["cfg"]
    model, params, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, cfg, device="cuda")
    gpu_params = {k: v.cuda() for k, v in params.items()}
    state = learner.init_state(gpu_params)
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")

    def fixture_step():
        advs, targets = learner.flat_advantages(staged)
        learner.loss_and_grads(state, staged, idx, advs, targets)

    with torch.enable_grad():
        step = cs.record_sites(cs.TRAIN_SITES, fixture_step)
    sites = ("csr_segment_mean_bwd", "csr_segment_sum",
             "masked_mean_pool_concat_bwd")
    step_calls = [(name, fn, a) for name in sites
                  for fn, a, _ in step[name]]
    for what, calls in (
            ("k6_step", [(n, lambda fn=fn, a=a: fn(*a))
                         for n, fn, a in step_calls]),
            ("k6_fuzzed", [(n, lambda n=n, a=a: getattr(segment, n)(*a))
                           for n, a in fuzz_k6_calls("cuda")])):
        counts = {}
        for name, call in calls:
            cur, old = _both(fns, k6, call)
            c = counts.setdefault(name, {"calls": 0, "differing": 0})
            c["calls"] += 1
            c["differing"] += not _same_outputs(cur, old)
        held[what] = counts
        bad += sum(c["differing"] for c in counts.values())
    # K17: row counts on three head widths, and the update's forward
    g = torch.Generator().manual_seed(17)
    for name, hiddens in (("shipped", (17,)), ("dqn", (256,)),
                          ("default", (256, 256))):
        lh, vh = _heads(hiddens, len(hiddens) + 3)
        n = diff = 0
        for rows in K17_ROWS:
            x = torch.randn(rows, 24, generator=g).cuda()
            cur, old = _both(fns, k17, lambda: policy.mlp_heads(
                x, lh, vh, "relu"))
            n += 1
            diff += not _same_outputs(cur, old)
        held[f"k17_{name}"] = {"calls": n, "differing": diff}
        bad += diff
    batch = learner.minibatch(staged, idx)
    (_, heads_args, _), = cs.record_sites(
        {"mlp_heads": (policy, "mlp_heads", cs.k17_parts)},
        lambda: learner.model.flat_batched(batch))["mlp_heads"]
    cur, old = _both(fns, k17, lambda: policy.mlp_heads(*heads_args))
    held["k17_update"] = {"calls": 1,
                          "differing": int(not _same_outputs(cur, old))}
    bad += held["k17_update"]["differing"]
    # K23: the shared form and the global form against the earlier build
    k23_held = {}
    for what, dev, args in _k23_cases("cuda"):
        with parent_entries(fns, k23):
            old = device_env.allocate_job(*args[:3], dev, args[3])
        for form in (0, 1):
            with kernels._forcing("allocate_job", form):
                cur = device_env.allocate_job(*args[:3], dev, args[3])
            key = f"{what} {device_env.ALLOC_FORMS[form]}"
            c = k23_held.setdefault(key, {"calls": 0, "differing": 0})
            c["calls"] += 1
            c["differing"] += not all(torch.equal(a, b)
                                      for a, b in zip(cur, old))
    held["k23"] = k23_held
    bad += sum(c["differing"] for c in k23_held.values())
    torch.cuda.synchronize()
    print(json.dumps({"part": "k6_k17_k23_bits", "card": card, **held}),
          flush=True)

    # device ms in turns
    def through(symbols, call, old):
        if not old:
            return call

        def run():
            with parent_entries(fns, symbols):
                return call()
        return run

    times = {}
    for name in sites:
        calls = [lambda fn=fn, a=a: fn(*a) for n, fn, a in step_calls
                 if n == name]
        times[f"{name}_update"] = turns(
            calls, [through(k6, c, True) for c in calls])
    update_heads = lambda: policy.mlp_heads(*heads_args)  # noqa: E731
    times["k17_update"] = turns([update_heads],
                                [through(k17, update_heads, True)])
    lh, vh = _heads((17,), 4)
    x8 = torch.randn(8, 24, generator=g).cuda()
    serve_heads = lambda: policy.mlp_heads(x8, lh, vh, "relu")  # noqa: E731
    times["k17_serve_8_rows"] = turns([serve_heads],
                                      [through(k17, serve_heads, True)])
    for name, hiddens, rows in (("dqn_32", (256,), 32),
                                ("dqn_512", (256,), 512),
                                ("default_128", (256, 256), 128),
                                ("shipped_4000", (17,), 4000)):
        lh2, vh2 = _heads(hiddens, 5)
        xr = torch.randn(rows, 24, generator=g).cuda()
        call = (lambda x_=xr, l_=lh2, v_=vh2:
                policy.mlp_heads(x_, l_, v_, "relu"))
        times[f"k17_{name}"] = turns([call], [through(k17, call, True)])
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
    from ddls_tpu_torch.sim import fixture as dfx

    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    dfx_fx = dfx.load_device_env_fixture()
    ek = device_env.episode_kernels(et, device="cuda", dtype=torch.float32)
    lanes = list(range(8))
    bank = {k: torch.from_numpy(np.ascontiguousarray(
        dfx_fx["banks"][k][lanes])).to("cuda", want or torch.float32)
        for k, want in device_env.BANK_FIELDS}
    acts = torch.from_numpy(np.stack([dfx_fx["actions"]] * 8)).to(
        "cuda", torch.int32)
    st = ek.init_state(bank, acts)
    free0 = st["srv_job"] < 0
    replay = lambda: device_env.allocate_job(  # noqa: E731
        st["mem"], free0, st["cfg"], ek.dev)
    times["k23_replay_8_lanes"] = turns([replay],
                                        [through(k23, replay, True)])
    mem, free, cfg_rows, lane = dfx.fuzzed_placements(et, ek.dev, 72, 0,
                                                      True)
    indexed = lambda: device_env.allocate_job(  # noqa: E731
        mem, free, cfg_rows, ek.dev, lane)
    times["k23_indexed_72_rows"] = turns([indexed],
                                         [through(k23, indexed, True)])
    print(json.dumps({"part": "device_ms", "card": card, **times}),
          flush=True)

    # a whole minibatch step, the earlier K6 and K17 swapped in
    perm0 = torch.as_tensor(fx["runs"][50]["perms"][0], device="cuda")

    def step_profile(old):
        st = learner.init_state(gpu_params)
        with torch.enable_grad():
            if old:
                with parent_entries(fns, k6 + k17):
                    return cs.profile_steps(learner, staged, st, perm0,
                                            n_steps=16)
            return cs.profile_steps(learner, staged, st, perm0, n_steps=16)

    keys = ("device_ms_per_step", "device_events_per_step", "wall_ms",
            "device_busy_share")
    steps = {}
    for label, old in (("parent", True), ("current", False),
                       ("current_again", False), ("parent_again", True)):
        prof = step_profile(old)
        steps[label] = {k: prof[k] for k in keys}
    print(json.dumps({"part": "minibatch_step", "card": card, **steps}),
          flush=True)
    return bad


K2_WIDTHS = (1, 3, 4, 5, 16, 17, 64, 128)


def fuzz_k2_calls(device):
    """K2's fuzzed calls: random CSR batches at the update's and serving's
    shapes, every width of ``K2_WIDTHS``, the messages also misaligned."""
    from ddls_tpu_torch.ops import segment

    rng = np.random.default_rng(2)
    for graphs, n, e in ((128, 38, 128), (8, 150, 512)):
        n_real = rng.integers(0, n + 1, graphs)
        n_real[-1] = 0
        dst = np.zeros(graphs * e, np.int64)
        mask = np.zeros(graphs * e, bool)
        for b in range(graphs):
            m = int(rng.integers(0, e + 1)) if n_real[b] else 0
            dst[b * e:b * e + m] = b * n + rng.integers(0, n_real[b] or 1, m)
            mask[b * e:b * e + m] = True
        node_mask = (np.arange(n)[None] < n_real[:, None]).reshape(-1)
        row_ptr, col = segment.build_csr(dst, mask, graphs * n)

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        rp, cl, nm = t(row_ptr), t(col), t(node_mask.astype(np.float32))
        for f in K2_WIDTHS:
            msg = t(rng.normal(size=(graphs * e, f)).astype(np.float32))
            own = t(rng.normal(size=(graphs * n, f)).astype(np.float32))
            yield (msg, own, rp, cl, nm)
            yield (_misaligned(msg), own, rp, cl, nm)


def _k20_cases(device):
    """(what, staged, idx, n, e) of K20's calls: the training fixture's
    samples staged at the (38, 128) and (150, 512) buckets."""
    from ddls_tpu_torch.rl.learner import TRAJ_OBS_KEYS, pack_to_device

    obs = load_train_fixture()["traj"]["obs"]
    s_rows = int(np.prod(np.shape(obs["node_split"])[:2]))
    rows = {k: np.swapaxes(np.asarray(obs[k]), 0, 1).reshape(
        (s_rows,) + np.shape(obs[k])[2:]) for k in TRAJ_OBS_KEYS}
    rng = np.random.default_rng(20)
    for n, e in ((38, 128), (150, 512)):
        cut = dict(rows)
        cut["node_features"] = rows["node_features"][:, :n]
        for key in ("edge_features", "edges_src", "edges_dst"):
            cut[key] = rows[key][:, :e]
        structure, node_mask = policy.sample_structure(cut)
        staged = pack_to_device({
            "node_features": cut["node_features"].astype(np.float32),
            "edge_features": cut["edge_features"].astype(np.float32),
            "graph_features": cut["graph_features"].astype(np.float32),
            "action_mask": cut["action_mask"].astype(np.int32),
            "structure": structure,
            "node_mask": node_mask.astype(np.float32)}, device)
        for what, idx in (("1", np.array([s_rows - 1])),
                          ("128", rng.integers(0, s_rows, 128)),
                          ("512", rng.integers(0, s_rows, 512)),
                          ("2", rng.integers(0, s_rows, 2)),
                          ("full", np.arange(s_rows)),
                          ("1024", rng.integers(0, s_rows, 1024)),
                          ("2048", rng.integers(0, s_rows, 2048)),
                          ("4000", rng.integers(0, s_rows, 4000))):
            yield (f"({n}, {e}) {what}", staged,
                   torch.from_numpy(idx.astype(np.int64)).to(device), n, e)


def check_k2_k20(fns, card) -> int:
    """K2's and K20's bits against the earlier build, their device ms and a
    minibatch step's in turns; returns the count of differing calls."""
    from ddls_tpu_torch.ops import segment

    k2 = ("ddls_csr_segment_mean",)
    k20 = ("ddls_minibatch_gather",)
    bad = 0
    held = {}
    fx = load_train_fixture()
    cfg = fx["cfg"]
    model, params, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, cfg, device="cuda")
    gpu_params = {k: v.cuda() for k, v in params.items()}
    learner.init_state(gpu_params)
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    sites = {"csr_segment_mean": cs.KERNEL_SITES["csr_segment_mean"]}
    batch = learner.minibatch(staged, idx)
    update = [a for _, a, _ in cs.record_sites(
        sites, lambda: learner.model.flat_batched(batch))[
            "csr_segment_mean"]]
    requests, _ = load_requests()
    model_gpu = load_export(EXPORT_PATH)[0].to("cuda").eval()
    serve = {}
    for n_pad, e_pad in (default_buckets(cs.PAD_NODES, cs.PAD_EDGES)[-1],
                         default_buckets(cs.PAD_NODES, cs.PAD_EDGES)[0]):
        b = cs.edge_case_batch(requests, n_pad, e_pad)
        serve[(n_pad, e_pad)] = [a for _, a, _ in cs.record_sites(
            sites, lambda: model_gpu.flat_batched(b))["csr_segment_mean"]]
    serve_calls = [a for calls in serve.values() for a in calls]
    for what, calls in (("k2_update", update), ("k2_serve", serve_calls),
                        ("k2_fuzzed", list(fuzz_k2_calls("cuda")))):
        c = {"calls": 0, "differing": 0}
        for args in calls:
            cur, old = _both(fns, k2,
                             lambda a=args: segment.csr_segment_mean(*a))
            c["calls"] += 1
            c["differing"] += not same_bits(cur, old)
        held[what] = c
        bad += c["differing"]
    k20_held = {}
    k20_cases = list(_k20_cases(torch.device("cuda")))
    for what, st, ix, n, e in k20_cases:
        with parent_entries(fns, k20):
            old = policy.minibatch_gather(st, ix, n, e)
        cur = policy.minibatch_gather(st, ix, n, e)
        c = k20_held[what] = {"calls": 1, "differing": int(not (
            set(cur) == set(old)
            and all(torch.equal(cur[k], old[k]) for k in cur)))}
        bad += c["differing"]
    held["k20"] = k20_held
    torch.cuda.synchronize()
    print(json.dumps({"part": "k2_k20_bits", "card": card, **held}),
          flush=True)

    def through(symbols, call):
        def run():
            with parent_entries(fns, symbols):
                return call()
        return run

    times = {}
    for k, f in enumerate((64, 16)):
        call = (lambda a=update[k]: segment.csr_segment_mean(*a))
        times[f"k2_update_f{f}"] = turns([call], [through(k2, call)])
    big = serve[default_buckets(cs.PAD_NODES, cs.PAD_EDGES)[-1]]
    calls = [lambda a=a: segment.csr_segment_mean(*a) for a in big]
    times["k2_serve_150_512"] = turns(calls,
                                      [through(k2, c) for c in calls])
    for what, st, ix, n, e in k20_cases:
        if what in ("(38, 128) 1", "(38, 128) 128", "(38, 128) 512",
                    "(38, 128) 1024", "(38, 128) 2048", "(38, 128) 4000",
                    "(150, 512) 2"):
            call = (lambda st=st, ix=ix, n=n, e=e:
                    policy.minibatch_gather(st, ix, n, e))
            times[f"k20 {what}"] = turns([call], [through(k20, call)])
    call = (lambda: learner.minibatch(staged, idx))
    times["k20_update_minibatch"] = turns([call], [through(k20, call)])
    print(json.dumps({"part": "device_ms", "card": card, **times}),
          flush=True)

    perm0 = torch.as_tensor(fx["runs"][50]["perms"][0], device="cuda")

    def step_profile(old):
        st = learner.init_state(gpu_params)
        with torch.enable_grad():
            if old:
                with parent_entries(fns, k2 + k20):
                    return cs.profile_steps(learner, staged, st, perm0,
                                            n_steps=16)
            return cs.profile_steps(learner, staged, st, perm0, n_steps=16)

    keys = ("device_ms_per_step", "device_events_per_step", "wall_ms",
            "device_busy_share")
    steps = {}
    for label, old in (("parent", True), ("current", False),
                       ("current_again", False), ("parent_again", True)):
        prof = step_profile(old)
        steps[label] = {k: prof[k] for k in keys}
    print(json.dumps({"part": "minibatch_step", "card": card, **steps}),
          flush=True)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="directory holding the earlier sources")
    ap.add_argument("--kernels", choices=sorted(PARENTS), default="k18k19",
                    help="which kernels to hold (default: k18k19)")
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
    parents = PARENTS[args.kernels]
    reports = kernels.build(list(parents))
    print(json.dumps({"part": "ptxas", **{
        stem: [line.strip() for line in text.splitlines()
               if "registers" in line or "spill" in line]
        for stem, text in reports.items()}}), flush=True)
    fns = build_parent(args.parent, args.build or tempfile.mkdtemp(),
                       parents)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    check = {"k1k5k8": check_k1_k5_k8, "k18k19": check_k18_k19,
             "k6k17k23": check_k6_k17_k23,
             "k2k20": check_k2_k20}[args.kernels]
    bad = check(fns, card)
    print(json.dumps({"ok": bad == 0, "differing": bad}), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
