"""Deterministic slices of the fuzzers' port mode: the 24 routine cases of
``test_fuzz.py`` (``fuzz_torch.py``, seed 20260816, ``max_n=2000``, the
plain path on the CPU) and the 10 mesh cases of ``test_fuzz_mesh.py``
(``fuzz_mesh_torch.py``, seed 20260825, worlds of up to 8 Gloo ranks on
the CPU, one world a size for all ten cases).

The campaigns are one command each:

    python tests/fuzz_torch.py --cases 257 --seed 20260816 --device cuda
    python tests/fuzz_mesh_torch.py --cases 100 --seed 20260825 --devices 8
"""

import pytest

import torch_dist
from fuzz_mesh_torch import run_cases
from fuzz_torch import run_case

CAMPAIGN_SEED = 20260816
MESH_SEED = 20260825
MESH_CASES = 10
MESH_RANKS = 8


@pytest.mark.parametrize("idx", range(24))
def test_fuzz_case(idx):
    run_case(idx, CAMPAIGN_SEED, device="cpu", max_n=2000)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    return torch_dist.shared_result(
        tmp_path_factory, "torch_fuzz_mesh",
        lambda d: run_cases(range(MESH_CASES), MESH_SEED, MESH_RANKS,
                            str(d)))


@pytest.mark.parametrize("idx", range(MESH_CASES))
def test_fuzz_mesh_case(mesh_results, idx):
    label, failure = mesh_results[idx]
    assert label.startswith(f"case {idx} (seed {MESH_SEED})")
    assert failure is None, failure
