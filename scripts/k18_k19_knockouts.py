"""Where K18's and K19's time goes, on the card.

    python3 scripts/k18_k19_knockouts.py [--build DIR]

K18 (``mlp_heads_bwd``): device ms of the update's shape (128 rows, the
shipped heads 24 -> 17 -> {17, 1}), of 8 to 64 rows and of the Ape-X
DQN's heads (24 -> 256 -> {17, 1}) at 512 rows, for K18 and for
copies of ``mlp_heads.cu`` with one phase taken out (the weight staging,
the tile's recompute and backward, or one of them: the recompute, the
parameter entries, d h; the reduce with its cluster barriers), one whose
activations compile to relu alone, an empty kernel body at the same grid and shared memory, and
K18 itself launched as other cluster shapes (the same CTAs and bits:
one cluster of 16, or clusters of 8, 4, 2 or 1 and a ticket). The copies
are written and built with the port's nvcc flags into --build (default:
a new temporary directory); their outputs are wrong by design: only
their times mean anything. K19 (``clip_adam``): device ms over the
shipped policy's leaves and DQN-sized ones at 1 to 16 CTAs (the same
bits), and, over the shipped leaves, of copies of ``clip_adam.cu`` with
its norm, its jobs' partials, its update or its whole body taken out, or
the update an add. One JSON line a part.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from ddls_tpu_torch import kernels  # noqa: E402
from ddls_tpu_torch.models import policy  # noqa: E402
from ddls_tpu_torch.rl import learner as learner_mod  # noqa: E402
from ddls_tpu_torch.rl import ppo  # noqa: E402
from ddls_tpu_torch.rl.fixture import load_train_fixture  # noqa: E402
from ddls_tpu_torch.serve import load_export  # noqa: E402
from ddls_tpu_torch.serve.fixture import EXPORT_PATH  # noqa: E402

K18_ROWS = (8, 16, 32, 64, 128)
# (cluster, clusters) launches of the 16 parts of 128 rows (one cluster of
# 16, or a ticket over clusters of 8 to 1), and the threads a CTA
K18_SHAPES = ((16, 1), (8, 2), (4, 4), (2, 8), (1, 16))
K18_THREADS = (256, 512)
K19_CTAS = (1, 2, 4, 8, 16)


def variants(src: str):
    """{name: source}: K18's source and copies with one phase taken
    out."""
    out = {
        "k18": src,
        "no_staging": src.replace(
            "      copy_async(sm + lay.b[h][l], L.b, L.out);\n"
            "      if (kResident) {", "      if (false) {"),
        "no_tile": src.replace(
            "    int cur[2] = {0, 0};  // which d buffer holds a head's "
            "current d\n    if (kResident) {",
            "    int cur[2] = {0, 0};  // which d buffer holds a head's "
            "current d\n    if (false) {").replace(
            "    } else {\n      // streaming: each head and layer in turn",
            "    } else if (false) {\n      // streaming: each head and "
            "layer in turn"),
        "no_recompute": src.replace(
            "      const int steps = max(heads.n_layers[0], heads.n_layers[1]) "
            "- 1;", "      const int steps = 0;"),
        "no_entries": src.replace(
            "            param_entry(Lh, pick(h1, d), pick(h1, hin), st, q,\n"
            "                        pick(h1, by_in), pick(h1, slot) + q, "
            "first);", ""),
        "no_dh": src.replace(
            "          const int r = (q - e) % kRowsBwd;",
            "          continue;\n          const int r = (q - e) % kRowsBwd;"),
        "relu_only": src.replace(
            "#include \"ln_row.cuh\"",
            "#include \"ln_row.cuh\"\n#define activate(z, act) "
            "activate(z, 0)\n#define activate_grad(z, act) "
            "activate_grad(z, 0)"),
        "no_reduce": re.sub(
            r"  // the gradient: \(\(0 \+ P_0\).*?\n\}\n\n// The layer table",
            "}\n\n// The layer table", src, flags=re.S),
        "empty": re.sub(
            r"(mlp_heads_bwd_kernel\(const float\* __restrict__ x,.*?\) \{)"
            r".*?\n\}\n\n// The layer table",
            r"\1\n}\n\n// The layer table", src, flags=re.S),
    }
    for name, text in out.items():
        if name != "k18" and text == src:
            raise RuntimeError(f"the {name} copy removed nothing: "
                               f"mlp_heads.cu changed; update the patterns")
    return out


def k19_variants(src: str):
    """{name: source}: K19's source and copies with one phase taken
    out."""
    out = {
        "k19": src,
        "no_norm": src.replace("  if (hp.has_clip) {\n    // each job's partial",
                               "  if (false) {\n    // each job's partial"),
        "no_update": src.replace("  for (int f = tid, k = 0; f < total;",
                                 "  for (int f = tid, k = 0; f < 0;"),
        "plain_update": src.replace(
            "    update_one(hp, norm, clip, lv.g[leaf][at], p, mu, nu);",
            "    p += lv.g[leaf][at];"),
        "no_partials": src.replace(
            "      const float part = n > 0 ? job_partial(\n"
            "          lv.g[leaf] + static_cast<size_t>(c) * kChunk, n, lane) "
            ": 0.0f;",
            "      const float part = n > 0 ? lv.g[leaf][lane] : 0.0f;"),
        "empty": re.sub(r"(clip_adam_kernel\(Leaves lv, Hyper hp\) "
                        r"\{).*?\n\}\n\n\}  // namespace",
                        r"\1\n}\n\n}  // namespace", src, flags=re.S),
    }
    for name, text in out.items():
        if name != "k19" and text == src:
            raise RuntimeError(f"the {name} copy removed nothing: "
                               f"clip_adam.cu changed; update the patterns")
    return out


def build(sources, out_dir, kernel="mlp_heads_bwd"):
    """Each copy into its own library, all at once; {name: the entry of
    ``kernel``}."""
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{kernel}_{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        for header in kernels.HEADERS:
            target = os.path.join(out_dir, header)
            if not os.path.exists(target):
                os.symlink(os.path.join(kernels.CSRC, header), target)
        lib = os.path.join(out_dir, f"lib{kernel}_{name}.so")
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{output}")
        spec = kernels.KERNELS[kernel]
        fn = getattr(ctypes.CDLL(lib), spec.symbol)
        fn.argtypes = [kernels._CTYPES[c] for c in spec.signature]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def k18_call(fn, args, cluster=None, clusters=None, threads=None):
    """One K18 launch through ``fn`` (a built copy's entry) with the
    wrapper's arguments, at the plan's cluster shape and threads or the
    ones given."""
    x, logit_layers, value_layers, activation, dlogits, dvalue = args
    table, n_params = policy._heads_table(x, logit_layers, value_layers,
                                          activation)
    rows = x.shape[0]
    parts, _, plan_cluster, plan_clusters = policy.heads_bwd_plan(rows)
    dx = x.new_empty(x.shape)
    grads = x.new_empty(n_params)
    partial = x.new_empty((parts, n_params))
    counter = kernels.stream_counters("mlp_heads_bwd", 1, x.device)

    def run():
        rc = fn(x.data_ptr(), ctypes.addressof(table), dlogits.data_ptr(),
                dvalue.data_ptr(), dx.data_ptr(), grads.data_ptr(),
                partial.data_ptr(), counter.data_ptr(), rows,
                policy._ACTIVATION_CODES[activation], parts,
                cluster or plan_cluster, clusters or plan_clusters,
                threads or policy._HEAD_BWD_THREADS,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K18 copy failed to launch: {rc}")
    return run


def k19_call(fn, state, grads, hp, ctas=None):
    """One K19 launch through ``fn`` with the wrapper's arguments, at the
    plan's CTAs or the ones given."""
    opt = learner_mod._optimizer_table(state, ctas)
    plan = opt.plan
    n = len(state.params)
    grad_table = (ctypes.c_int64 * n)(*(x.data_ptr() for x in grads))
    f32 = np.float32

    def run():
        rc = fn(ctypes.addressof(grad_table), ctypes.addressof(opt.table), n,
                plan.chunks, plan.ctas, 1, learner_mod._OPT_RULES[hp.rule], float(hp.grad_clip), hp.lr,
                hp.b1, float(f32(1.0 - hp.b1)), hp.b2,
                float(f32(1.0 - hp.b2)), hp.eps, hp.bc1, hp.bc2,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K19 copy failed to launch: {rc}")
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", default=None,
                    help="where the copies are built (default: a new "
                         "temporary directory)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k18_k19_knockouts: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kernels.build(["mlp_heads", "clip_adam"])
    out_dir = args.build or tempfile.mkdtemp()
    with open(os.path.join(kernels.CSRC, "mlp_heads.cu")) as fh:
        k18_src = fh.read()
    with open(os.path.join(kernels.CSRC, "clip_adam.cu")) as fh:
        k19_src = fh.read()
    fns = build(variants(k18_src), out_dir)
    k19_fns = build(k19_variants(k19_src), out_dir, "clip_adam")

    fx = load_train_fixture()
    cfg = fx["cfg"]
    model, params, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, cfg, device="cuda")
    gpu_params = {k: v.cuda() for k, v in params.items()}
    learner.init_state(gpu_params)
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    batch = learner.minibatch(staged, idx)
    (_, heads_args, _), = cs.record_sites(
        {"mlp_heads": (policy, "mlp_heads", cs.k17_parts)},
        lambda: learner.model.flat_batched(batch))["mlp_heads"]
    g = torch.Generator().manual_seed(19)
    x = heads_args[0]
    update = (*heads_args, torch.randn(x.shape[0], 17, generator=g).cuda(),
              torch.randn(x.shape[0], generator=g).cuda())
    dqn = (torch.randn(512, 24, generator=g).cuda(),
           *cs._random_heads((256,), 17, 2), "relu",
           torch.randn(512, 17, generator=g).cuda(),
           torch.randn(512, generator=g).cuda())
    phases = {}
    for name, fn in fns.items():
        phases[name] = {"rows=128 (update)": cs.device_ms(
            k18_call(fn, update)), "rows=512 (dqn heads)": cs.device_ms(
            k18_call(fn, dqn))}
        for rows in K18_ROWS[:-1]:
            part = tuple(t[:rows] if t.dim() and t.shape[0] == x.shape[0]
                         else t for t in (update[0], *update[4:]))
            a = (part[0], *update[1:4], *part[1:])
            phases[name][f"rows={rows}"] = cs.device_ms(k18_call(fn, a))
    print(json.dumps({"part": "k18_phases", "card": card, **phases}),
          flush=True)
    shapes = {f"{c}x{n}": cs.device_ms(k18_call(fns["k18"], update, c, n))
              for c, n in K18_SHAPES}
    print(json.dumps({"part": "k18_cluster_shapes", "card": card,
                      "rows": 128, "parts": 16, **shapes}), flush=True)
    threads = {f"{t} {what}": cs.device_ms(k18_call(fns["k18"], a,
                                                    threads=t))
               for t in K18_THREADS
               for what, a in (("update", update), ("dqn 512", dqn))}
    print(json.dumps({"part": "k18_threads", "card": card, **threads}),
          flush=True)

    sweep = {}
    state = learner.init_state(gpu_params)
    grads = [torch.randn(p.shape, generator=g).cuda() for p in state.params]
    hp = learner_mod.OptimizerStep(
        "adam", cfg.lr, cfg.grad_clip, learner_mod.ADAM_B1,
        learner_mod.ADAM_B2, learner_mod.ADAM_EPS, 0.1, 1e-3)
    dqn_sizes = [256 * 24, 256, 17 * 256, 17, 256 * 24, 256, 256, 1, 3000]
    dqn = learner_mod.TrainState(
        names=[str(i) for i in range(len(dqn_sizes))],
        params=[torch.randn(s, generator=g).cuda() for s in dqn_sizes],
        mu=[torch.zeros(s, device="cuda") for s in dqn_sizes],
        nu=[torch.zeros(s, device="cuda") for s in dqn_sizes])
    dqn_grads = [torch.randn(p.shape, generator=g).cuda()
                 for p in dqn.params]
    for what, st, gr in (("shipped", state, grads), ("dqn", dqn, dqn_grads)):
        sweep[what] = {
            "plan_ctas": learner_mod.clip_adam_plan(
                [p.numel() for p in st.params]).ctas,
            **{str(c): cs.forced_ms("clip_adam", c, lambda: learner_mod.
                clip_adam(st, gr, hp)) for c in K19_CTAS}}
    print(json.dumps({"part": "k19_ctas", "card": card, **sweep}),
          flush=True)
    k19 = {}
    for ctas in (1, 4, 8):
        for name, fn in k19_fns.items():
            k19[f"{name} ctas={ctas}"] = cs.device_ms(
                k19_call(fn, state, grads, hp, ctas))
    print(json.dumps({"part": "k19_phases", "card": card, **k19}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
