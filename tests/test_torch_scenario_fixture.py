"""The scenario recordings (``ddls_tpu_torch/data/scenario_recorded.npz``)
regenerate bit for bit: ``scripts/export_torch_scenario_fixture.py`` run
again in process with a short full-width prefix gives every array of the
archive: the specs, the fuzzed walk, the failures episode, C1's bank, the
full-width banks and actions in full, and the first decisions of the
full-width replays (a causal replay: the archive's first columns). The
full-width spec file loads in the reference to the recorded fingerprint.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_scenario_fixture as scenario_export  # noqa: E402
from ddls_tpu_torch.sim.fixture import (FULL_SCENARIO_PATH,  # noqa: E402
                                        SCENARIO_PATH)

PREFIX = 8


def test_scenario_fixture_regenerates_bit_for_bit():
    from ddls_tpu.scenarios import get_spec, spec_fingerprint

    fresh = scenario_export.export_fixture(prefix=PREFIX)
    with np.load(SCENARIO_PATH, allow_pickle=False) as data:
        committed = {k: data[k] for k in data.files}
    checked = 0
    for key, value in fresh.items():
        got = committed[key]
        if key.startswith(("full/f32/trace/", "full/x64/trace/")):
            got = got[:, :PREFIX]
        assert got.dtype == value.dtype, key
        np.testing.assert_array_equal(got, value, err_msg=key)
        checked += 1
    # only the full-width replays' later columns and counters are left out
    left = {k for k in committed if k not in fresh}
    assert left == {k for k in committed
                    if k.startswith(("full/f32/counters/",
                                     "full/x64/counters/"))}
    assert checked > 100
    assert str(committed["spec/failures_load32/fingerprint"]) == \
        spec_fingerprint(get_spec(FULL_SCENARIO_PATH))
    assert os.path.getsize(SCENARIO_PATH) < 300_000
