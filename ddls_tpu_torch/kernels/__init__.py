"""The port's hand-written CUDA kernels: built with ``nvcc`` at first use,
bound with ``ctypes``.

Each source under ``csrc/`` is one library of plain C entry points (most
hold one kernel; a backward source may hold a few). At first use every
library that is missing is compiled, one ``nvcc`` per source, all started
together, for ``sm_90a`` into ``_build/`` beside this file (listed in
``.gitignore``; no binary is committed). A library's file name carries a
digest of its sources and flags, so a changed source builds anew and a
fresh process reuses what an earlier one built.

Nothing here runs at import, so the module imports on a machine without
``nvcc`` or a card; only ``build()`` and ``launch()`` need them.

The wrappers that launch these kernels live beside their plain PyTorch
versions, in the modules that call them (``ln_linear_act`` and its
backward in ``models/gnn.py``; ``csr_segment_mean``,
``masked_mean_pool_concat`` and their backwards in ``ops/segment.py``;
``mask_logits_argmax`` and ``mask_sample_logp`` in ``models/policy.py``;
``gae_normalize`` and ``ppo_loss`` in ``rl/ppo.py``; ``vtrace`` in
``rl/impala.py``; ``reward_to_go`` in ``rl/pg.py``; ``ac_logp`` and
``ac_loss``, which both of those learners call, in ``rl/actor_critic.py``;
``dqn_act`` and ``dqn_td_loss`` in ``rl/dqn.py``; ``es_update`` and
``es_act`` in ``rl/es.py``; ``mlp_heads`` and its backward, and
``minibatch_gather``, in ``models/policy.py``; ``clip_adam``, which every
learner calls, in ``rl/learner.py``; ``lookahead`` in ``sim/lookahead.py``;
``first_fit_block`` in ``sim/device_block_search.py``; ``allocate_job``,
``price_and_score``, ``episode_step`` (and its scenario mode,
``episode_step_scenario``), ``episode_prepare``,
``kernel_obs``, ``price_reduce`` and ``oracle_select`` in
``sim/device_env.py``; ``memo_probe`` and
``memo_insert`` in ``sim/device_memo.py``);
each wrapper checks its tensors with
``check_cuda`` and launches with ``launch``, which raises if the C entry
reports a CUDA error and otherwise counts the launch (``launch_counts``,
one count per entry point).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEADERS = ("common.cuh", "ln_row.cuh", "ln_tile.cuh", "cluster.cuh")
# per-source flags after NVCC_FLAGS: the device env's sources keep every
# float sum and product apart unless the source fuses it itself, as the
# reference's arithmetic does
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    stem: ("-fmad=false",) for stem in ("placement", "pricing", "episode",
                                        "obs", "memo", "oracle",
                                        "lookahead")}
# the largest thread-block cluster a lane of K21 or K24 spreads over (the
# H100's non-portable maximum)
MAX_CLUSTER = 16


@dataclass(frozen=True)
class KernelSpec:
    """One kernel entry point: its C symbol and ctypes signature (``p`` a
    pointer or stream, ``i`` a C int, ``f`` a C float, ``d`` a C double),
    the JAX routine it
    replaces, and the source stem it lives in (default: its name)."""
    name: str
    symbol: str
    signature: str
    replaces: str
    file: str = ""

    @property
    def stem(self) -> str:
        return self.file or self.name

    @property
    def source(self) -> str:
        return os.path.join(CSRC, f"{self.stem}.cu")


# K25's entry: the state, trace, bank, actions, the decision's outputs,
# the tables, the segment's counters and fields (56 pointers), the sizes
# and flags, the constants, the float type, then the scenario's tables
# (6 pointers, null for none), its window count, the forced forms and the
# slots a lane of warp 0
_EPISODE_STEP_SIG = ("p" * 56 + "i" * 15 + "d" * 5 + "i" + "p" * 6 + "i" * 3
                     + "p")

KERNELS: Dict[str, KernelSpec] = {k.name: k for k in (
    KernelSpec("ln_linear_act", "ddls_ln_linear_act",
               "p" * 8 + "i" * 8 + "p",
               "ddls_tpu/models/gnn.py:45"),
    KernelSpec("csr_segment_mean", "ddls_csr_segment_mean", "ppppppiip",
               "ddls_tpu/ops/segment.py:37"),
    KernelSpec("masked_mean_pool_concat", "ddls_masked_mean_pool_concat",
               "ppppiiiip",
               "ddls_tpu/ops/segment.py:61"),
    KernelSpec("mask_logits_argmax", "ddls_mask_logits_argmax", "ppppiip",
               "ddls_tpu/models/policy.py:87"),
    # rollout sampling (K9)
    KernelSpec("mask_sample_logp", "ddls_mask_sample_logp", "pppppiip",
               "ddls_tpu/rl/ppo.py:262"),
    # the PPO update's backward (K5, K6) and loss (K7, K8)
    KernelSpec("ln_linear_act_bwd", "ddls_ln_linear_act_bwd",
               "p" * 14 + "i" * 9 + "p", "ddls_tpu/models/gnn.py:45"),
    KernelSpec("csr_segment_mean_bwd", "ddls_csr_segment_mean_bwd",
               "ppppppiiiip", "ddls_tpu/ops/segment.py:37",
               file="segment_bwd"),
    KernelSpec("csr_segment_sum", "ddls_csr_segment_sum", "ppppiip",
               "ddls_tpu/models/gnn.py:89", file="segment_bwd"),
    KernelSpec("masked_mean_pool_concat_bwd",
               "ddls_masked_mean_pool_concat_bwd", "ppppiiiiip",
               "ddls_tpu/ops/segment.py:61", file="segment_bwd"),
    KernelSpec("gae_normalize", "ddls_gae_normalize", "ppppppiiffip",
               "ddls_tpu/rl/ppo.py:101"),
    KernelSpec("ppo_loss", "ddls_ppo_loss",
               "p" * 12 + "i" * 5 + "f" * 6 + "p",
               "ddls_tpu/rl/ppo.py:124"),
    # the IMPALA and PG updates' scans (K10, K11) and loss (K12)
    KernelSpec("vtrace", "ddls_vtrace", "ppppppppiifffp",
               "ddls_tpu/rl/impala.py:69", file="reverse_scan"),
    KernelSpec("reward_to_go", "ddls_reward_to_go", "pppiifp",
               "ddls_tpu/rl/pg.py:49", file="reverse_scan"),
    KernelSpec("ac_logp", "ddls_ac_logp", "pppiip",
               "ddls_tpu/rl/impala.py:201", file="ac_loss"),
    KernelSpec("ac_loss", "ddls_ac_loss", "pppppppppppiiiifffp",
               "ddls_tpu/rl/impala.py:201", file="ac_loss"),
    # the Ape-X DQN acting and update (K13, K14) and the ES update and
    # acting (K15, K16)
    KernelSpec("dqn_act", "ddls_dqn_act", "pppppppiiifp",
               "ddls_tpu/rl/dqn.py:262", file="dqn"),
    KernelSpec("dqn_td_loss", "ddls_dqn_td_loss",
               "p" * 17 + "iiiiffp", "ddls_tpu/rl/dqn.py:290", file="dqn"),
    KernelSpec("es_update", "ddls_es_update", "ppppppiiffp",
               "ddls_tpu/rl/es.py:63", file="es"),
    KernelSpec("es_act", "ddls_es_act", "ppppiifp",
               "ddls_tpu/rl/es.py:133", file="es"),
    # the heads forward and backward (K17, K18), the optimiser (K19) and
    # the minibatch assembly (K20) that every update runs
    KernelSpec("mlp_heads", "ddls_mlp_heads", "ppppiiip",
               "ddls_tpu/models/policy.py:38"),
    KernelSpec("mlp_heads_bwd", "ddls_mlp_heads_bwd", "p" * 8 + "i" * 6 + "p",
               "ddls_tpu/models/policy.py:38", file="mlp_heads"),
    KernelSpec("clip_adam", "ddls_clip_adam", "pp" + "i" * 5 + "f" * 9 + "p",
               "ddls_tpu/rl/ppo.py:206"),
    KernelSpec("minibatch_gather", "ddls_minibatch_gather",
               "p" * 18 + "iiiiiiip", "ddls_tpu/rl/ppo.py:343"),
    # the simulator's array lookahead engine (K21): the env's
    # use_jax_lookahead and candidate_pricing="jax" options
    KernelSpec("lookahead", "ddls_lookahead", "p" * 20 + "i" * 10 + "p",
               "ddls_tpu/sim/jax_lookahead.py:313"),
    # the device episode replay: the block-search primitive (K22), the
    # placement scan (K23), dep pricing and SRPT scores (K24), the commit
    # and the event clock (K25)
    KernelSpec("first_fit_block", "ddls_first_fit_block", "ppppiiiiiiiip",
               "ddls_tpu/sim/jax_block_search.py:62", file="placement"),
    KernelSpec("allocate_job", "ddls_allocate_job", "p" * 17 + "i" * 12 + "p",
               "ddls_tpu/sim/jax_env.py:450", file="placement"),
    KernelSpec("price_and_score", "ddls_price_and_score",
               "p" * 33 + "i" * 11 + "dddd" + "i" + "p",
               "ddls_tpu/sim/jax_env.py:606", file="pricing"),
    KernelSpec("episode_step", "ddls_episode_step", _EPISODE_STEP_SIG,
               "ddls_tpu/sim/jax_env.py:974", file="episode"),
    # device collection: the step's config row once its action is sampled
    # (K25's prepare half), the in-kernel observation (K26) and the
    # lookahead memo's probe and insert (K27, K28)
    KernelSpec("episode_prepare", "ddls_episode_prepare", "p" * 7 + "i" * 5
               + "p", "ddls_tpu/sim/jax_env.py:1596", file="episode"),
    KernelSpec("kernel_obs", "ddls_kernel_obs", "p" * 14 + "i" * 7 + "p",
               "ddls_tpu/sim/jax_env.py:1409", file="obs"),
    KernelSpec("memo_probe", "ddls_memo_probe", "p" * 19 + "i" * 7 + "p",
               "ddls_tpu/sim/jax_memo.py:201", file="memo"),
    KernelSpec("memo_insert", "ddls_memo_insert", "p" * 24 + "i" * 9 + "p",
               "ddls_tpu/sim/jax_memo.py:201", file="memo"),
    # in-kernel candidate pricing: K23 with the state-lane index and K26
    # with the price block (the same entry points, counted apart from
    # their other mode), the verdicts and prices (K29) and the OracleJCT
    # episode's choice of degree (K30)
    KernelSpec("allocate_job_indexed", "ddls_allocate_job",
               "p" * 17 + "i" * 12 + "p", "ddls_tpu/sim/jax_env.py:1085",
               file="placement"),
    KernelSpec("kernel_obs_prices", "ddls_kernel_obs",
               "p" * 14 + "i" * 7 + "p", "ddls_tpu/sim/jax_env.py:1492",
               file="obs"),
    KernelSpec("price_reduce", "ddls_price_reduce", "p" * 14 + "i" * 8 + "p",
               "ddls_tpu/sim/jax_env.py:1085", file="oracle"),
    KernelSpec("oracle_select", "ddls_oracle_select",
               "p" * 12 + "i" * 5 + "p", "ddls_tpu/sim/jax_env.py:1799",
               file="oracle"),
    # the scenario's failure walk: K25 with the scenario's tables (the
    # same entry point, counted apart from its nominal mode)
    KernelSpec("episode_step_scenario", "ddls_episode_step",
               _EPISODE_STEP_SIG, "ddls_tpu/scenarios/failures.py:137",
               file="episode"),
)}
# one library per source stem
SOURCES: Tuple[str, ...] = tuple(dict.fromkeys(k.stem
                                               for k in KERNELS.values()))

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "d": ctypes.c_double}
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes._CFuncPtr] = {}
# launches per kernel since the last reset: how a run shows that it went
# through the kernels (chip_smoke.py resets, serves, then reads them)
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def library_path(stem: str) -> str:
    """``_build/lib<stem>-<digest>.so``: the digest covers the source, the
    shared headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS
                                     + EXTRA_FLAGS.get(stem, ())).encode())
    for path in (os.path.join(CSRC, f"{stem}.cu"),
                 *(os.path.join(CSRC, h) for h in HEADERS)):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(stems: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile every source stem in ``stems`` (default: all) whose library
    is not built yet: one ``nvcc`` per source, all started together, each
    into a temporary file renamed into place when it succeeds. Returns the
    ``-Xptxas -v`` report per source compiled now (registers, shared
    memory, spills); raises with the compiler's output if any failed,
    after every started compile has ended."""
    stems = list(SOURCES) if stems is None else list(stems)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for stem in stems:
        path = library_path(stem)
        if os.path.exists(path):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(stem, ()), "-o", tmp,
               os.path.join(CSRC, f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    reports, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{output}")
            continue
        os.replace(tmp, path)
        reports[name] = output
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def _function(stem: str, symbol: str, signature: str) -> ctypes._CFuncPtr:
    with _LOCK:
        fn = _LOADED.get(symbol)
        if fn is None:
            path = library_path(stem)
            if not os.path.exists(path):
                build([stem])
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.argtypes = [_CTYPES[c] for c in signature]
            fn.restype = ctypes.c_int
            _LOADED[symbol] = fn
        return fn


def _symbol(name: str) -> ctypes._CFuncPtr:
    spec = KERNELS[name]
    return _function(spec.stem, spec.symbol, spec.signature)


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry with ``args`` followed by PyTorch's
    current stream; raise if it reports a CUDA error (a refused launch
    never runs, and a later synchronise would not say so), else count the
    launch."""
    fn = _symbol(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    with _LOCK:
        _LAUNCHES[name] += 1


def query(stem: str, symbol: str, *args: int) -> int:
    """Call the C function ``symbol`` of source ``stem`` that takes
    ``args`` (C ints) and writes one int through its last argument (a
    size or a count; it launches nothing). Raises on a CUDA error."""
    fn = _function(stem, symbol, "i" * len(args) + "p")
    out = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{symbol} failed: cudaError {rc}")
    return out.value


_QUERIES: Dict[Tuple, int] = {}


def cached_query(stem: str, symbol: str, *args: int) -> int:
    """``query``, answered once per device and arguments."""
    key = (torch.cuda.current_device(), stem, symbol, *args)
    if key not in _QUERIES:
        _QUERIES[key] = query(stem, symbol, *args)
    return _QUERIES[key]


def choose_cluster(lanes: int, sms: int, fits=None) -> int:
    """The cluster size of a launch of ``lanes`` lanes, one cluster a
    lane: the largest power of two G <= ``MAX_CLUSTER`` whose clusters the
    card runs at once, or all but an eighth of them (a short second wave:
    the lanes' extents differ, so the first clusters free their SMs
    early).
    ``fits(G)`` says how many clusters of G CTAs the card runs at once
    (default: ``sms // G``, one CTA an SM); 1 when no larger G
    qualifies."""
    best, g = 1, 2
    while g <= MAX_CLUSTER:
        at_once = fits(g) if fits is not None else sms // g
        if lanes <= at_once + at_once // 8:
            best = g
        g *= 2
    return best


# the in-launch reduces' ticket counters (K5, K18): one set a (owner,
# device, stream), zero between launches; launches on one stream run in
# order, so no two share a set at once
_COUNTERS: Dict[Tuple[str, int, int], torch.Tensor] = {}


def stream_counters(owner: str, n: int, device: torch.device) -> torch.Tensor:
    """``n`` int32 ticket counters of kernel ``owner`` on ``device`` for
    the current stream (the one ``launch`` launches on), made (zeroed) at
    the stream's first call; the kernel sets each back to 0. A set made
    inside a CUDA-graph capture would be zeroed only when that graph
    replays, so the first call on a stream must come before any capture on
    it."""
    key = (owner, device.index, torch.cuda.current_stream().cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{owner}: first call on this stream during a CUDA-graph "
                f"capture; call it once on the capture stream before "
                f"capturing")
        counters = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                                device=device)
    return counters


# what a test forces on a kernel whose form its sizes choose (the kernel's
# name -> the value its wrapper reads): K6's scalar form
# ("csr_segment_mean_bwd", "masked_mean_pool_concat_bwd": "scalar"), K17's tile ("mlp_heads"), K23's form ("allocate_job": an
# index of sim/device_env.py ALLOC_FORMS), K19's CTAs ("clip_adam"), K21's
# channel table in the workspace ("lookahead"), K25's forms
# ("episode_step": names of sim/device_env.py EPISODE_FORMS), K29's
# occupancy from global memory ("price_reduce"). Empty unless a test sets
# it with ``_forcing``; every form gives the same bits.
_FORCED: Dict[str, Any] = {}


def forced(name: str, default: Any = None) -> Any:
    """What a test forces on kernel ``name`` (``default``: nothing)."""
    return _FORCED.get(name, default)


@contextlib.contextmanager
def _forcing(name: str, value: Any) -> Iterator[None]:
    """Force ``value`` on kernel ``name``'s wrapper inside the block."""
    _FORCED[name] = value
    try:
        yield
    finally:
        del _FORCED[name]


def sm_count() -> int:
    """The current CUDA device's streaming multiprocessors."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    with _LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Optional[Sequence[int]] = None) -> None:
    """What a kernel takes: a contiguous tensor of ``dtype`` (and
    ``shape``) on the current CUDA device. Raises on anything else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.device.index != \
            torch.cuda.current_device():
        raise ValueError(f"{name} must lie on the current CUDA device "
                         f"(cuda:{torch.cuda.current_device()}), got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True when every given tensor lies on the CPU (the wrapper then takes
    the plain version), False when all lie on CUDA devices (it launches the
    kernel); raises for a mix or any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on "
                     f"CUDA, got devices {sorted(kinds)}")


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd is recording and a given tensor requires grad: a
    wrapper then launches through its ``torch.autograd.Function`` (whose
    backward is a kernel too); otherwise it launches the forward alone."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
