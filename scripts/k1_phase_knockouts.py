"""Where K1's time goes, on the card: device ms of each call of serving's
forward and of the PPO update's first minibatch forward, for K1 and for
copies of it with one phase taken out.

    python3 scripts/k1_phase_knockouts.py [--build DIR]

The copies (``ln_linear_act.cu`` with its row statistics, its products
and stores, its parameter staging or its row loads removed, and an empty
kernel body at the same grid and shared memory) are written and built with
the port's nvcc flags into --build (default: a new temporary directory).
Their outputs are wrong by design: only their times mean anything, as the
time a phase adds to the call's chain. One JSON line a forward.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
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


def variants(src: str):
    """{name: source}: K1 and its copies with one phase taken out."""
    stats = re.compile(r"    // every row of a warp's share.*?\n    \}\n",
                       re.S)
    out = {
        "k1": src,
        "no_stats": stats.sub("", src),
        "no_products": src.replace("ddls::z_tiles(t, wt_s, y_t, tid,",
                                   "if (0) ddls::z_tiles(t, wt_s, y_t, tid,"),
        "no_params": src.replace(
            "ddls::stage_params(t, smem, w, bias, ln_w, ln_b, false, tid);",
            ""),
        "no_loads": src.replace(
            "  ddls::load_x(t, smem + t.xbuf, tile, rows, tid, a, idx, b, "
            "fa, fb,\n               b_given);", ""),
        "empty": re.sub(r"(ln_linear_act_kernel\(.*?\) \{).*?\n\}\n\nsize_t",
                        r"\1\n}\n\nsize_t", src, flags=re.S)}
    for name, text in out.items():
        if name != "k1" and text == src:
            raise RuntimeError(f"the {name} copy removed nothing: "
                               f"ln_linear_act.cu's text has changed")
    return out


def build(out_dir: str):
    for header in kernels.HEADERS:
        shutil.copy(os.path.join(kernels.CSRC, header), out_dir)
    with open(os.path.join(kernels.CSRC, "ln_linear_act.cu")) as fh:
        sources = variants(fh.read())
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{output}")
        fn = ctypes.CDLL(lib).ddls_ln_linear_act
        fn.argtypes = [kernels._CTYPES[c]
                       for c in kernels.KERNELS["ln_linear_act"].signature]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launcher(fn, a, ln_w, ln_b, w, bias, activation, idx=None, b=None,
             b_width=0, **_):
    """A call of ``fn`` on one recorded K1 call's inputs, and its shape."""
    rows, fa, fb, fo = gnn._check_ln_linear_act(a, ln_w, ln_b, w, bias,
                                                activation, idx, b, b_width)
    out = a.new_empty((rows, fo))
    blocks, _, tile = gnn.fwd_grid(rows)
    args = (a.data_ptr(), kernels.ptr(idx), kernels.ptr(b), ln_w.data_ptr(),
            ln_b.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, fa, fb, int(b is not None), fo,
            gnn._ACTIVATION_CODES[activation], tile, blocks)

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    gather = " gather" if idx is not None else ""
    return run, (f"rows={rows} in={fa}+{fb}{gather} out={fo} tile={tile} "
                 f"ctas={blocks}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_knockouts: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    fns = build(args.build or tempfile.mkdtemp())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    model, params, _ = load_export(EXPORT_PATH)
    requests, _ = load_requests()
    buckets = default_buckets(cs.PAD_NODES, cs.PAD_EDGES)
    serve = cs.record_calls(model.to("cuda").eval(), cs.edge_case_batch(
        requests, *buckets[-1]))["ln_linear_act"]
    fx = load_train_fixture()
    cfg = fx["cfg"]
    learner = ppo.PPOLearner(load_export(EXPORT_PATH)[0], cfg,
                             device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    batch = learner.minibatch(staged, idx)
    update = cs.record_sites(
        {"ln_linear_act": cs.KERNEL_SITES["ln_linear_act"]},
        lambda: learner.model.flat_batched(batch))["ln_linear_act"]
    for what, calls in (("serve", serve), ("update", update)):
        per_call = []
        for _, a, kw in calls:
            times = {}
            for name, fn in fns.items():
                run, shape = launcher(fn, *a, **kw)
                times[name] = cs.device_ms(run)
            per_call.append({"shape": shape, **times})
        totals = {name: sum(c[name] for c in per_call) for name in fns}
        print(json.dumps({"forward": what, "card": card, "total_ms": totals,
                          "calls": per_call}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
