"""Import hygiene of the port: ddls_tpu_torch (the simulator copy, the
native engine's loader, the rollout collector, the PPO, IMPALA, PG, Ape-X
DQN and ES learners, the fixture loaders, the loops and their entry point,
the device env and its block search included) and chip_smoke.py import nothing of JAX, flax, orbax,
PyYAML or the JAX package.

A child interpreter installs a ``sys.meta_path`` finder that refuses those
names, then imports every module of ddls_tpu_torch and chip_smoke.py; the
script's own import statements are also parsed for the names.
"""
import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "yaml", "ddls_tpu")

_CHILD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {blocked!r}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())
    sys.path.insert(0, {repo!r})
    import ddls_tpu_torch

    names = ["ddls_tpu_torch"]
    for info in pkgutil.walk_packages(ddls_tpu_torch.__path__,
                                      "ddls_tpu_torch."):
        names.append(info.name)
    for name in names:
        importlib.import_module(name)
    assert {{"ddls_tpu_torch.rl", "ddls_tpu_torch.rl.ppo",
             "ddls_tpu_torch.rl.learner", "ddls_tpu_torch.rl.impala",
             "ddls_tpu_torch.rl.pg", "ddls_tpu_torch.rl.actor_critic",
             "ddls_tpu_torch.rl.dqn", "ddls_tpu_torch.rl.es",
             "ddls_tpu_torch.rl.fixture", "ddls_tpu_torch.serve.fixture",
             "ddls_tpu_torch.rl.rollout", "ddls_tpu_torch.rl.shm",
             "ddls_tpu_torch.rl.ring", "ddls_tpu_torch.train.metrics",
             "ddls_tpu_torch.train.loops", "ddls_tpu_torch.train.__main__",
             "ddls_tpu_torch.train.checkpointer", "ddls_tpu_torch.native",
             "ddls_tpu_torch.sim.cluster",
             "ddls_tpu_torch.sim.candidate_pricing",
             "ddls_tpu_torch.sim.lookahead_arrays",
             "ddls_tpu_torch.sim.device_block_search",
             "ddls_tpu_torch.sim.device_env",
             "ddls_tpu_torch.envs.partitioning_env",
             "ddls_tpu_torch.demands.jobs_generator",
             "ddls_tpu_torch.graphs.synthetic",
             "ddls_tpu_torch.hardware.topologies",
             "ddls_tpu_torch.agents.placers",
             "ddls_tpu_torch.utils.common"}} <= set(names), names
    import chip_smoke
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
""")


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=BLOCKED, repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # every subpackage and module was walked, __main__ included
    assert int(proc.stdout.strip().splitlines()[-1]) >= 63


def test_port_sources_name_no_jax_import():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "ddls_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, (path, name)


def test_kernel_signatures_match_their_c_entry_points():
    """Each KernelSpec's ctypes signature is its C entry's parameter list
    (``p`` a pointer, ``i`` an int, ``f`` a float, ``d`` a double): a
    wrong one would pass
    arguments the card then misreads, which nothing on the CPU would
    catch."""
    import re

    sys.path.insert(0, REPO)
    from ddls_tpu_torch import kernels

    for spec in kernels.KERNELS.values():
        with open(spec.source) as fh:
            text = fh.read()
        found = re.search(r"DDLS_EXPORT int " + spec.symbol
                          + r"\((.*?)\)\s*\{", text, re.S)
        assert found, spec.symbol
        params = [p.strip() for p in found.group(1).split(",")]
        sig = "".join("p" if "void*" in p else
                      "f" if p.startswith("float") else
                      "d" if p.startswith("double") else "i" for p in params)
        assert sig == spec.signature, (spec.name, sig)
    assert set(kernels.SOURCES) == {os.path.splitext(f)[0] for f in
                                    os.listdir(kernels.CSRC)
                                    if f.endswith(".cu")}
