"""The tp group's collectives on CUDA tensors over gloo (two ranks on
cuda:0, as chip_smoke.py's tensor-parallel phase runs them): each of
all-reduce, all-gather and broadcast on f32 (the dtype the tp forward's
collectives carry), by the route that `TPGroup`'s first-use check picks
and again staged through pinned host memory (`TPGroup.routes` set to
"host"), every result exact against the sum, concatenation or copy of the
ranks' seeded inputs and back on the card
(`jlama_tpu_torch/scripts/tp_check.py::route_check`).

Marked `cuda`: it skips where torch has no CUDA device (as on the CPU test
runs); on a machine with an NVIDIA GPU run it with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tp.py -m cuda -q`.
The two rank processes start with `spawn`, meet through a FileStore in
tmp_path and have a deadline of their own (90 s)."""

import pickle

import pytest
import torch

from jlama_tpu_torch.scripts import tp_check

pytestmark = pytest.mark.cuda

WORLD, DEADLINE = 2, 90


def test_gloo_collectives_direct_and_staged_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the collectives on CUDA tensors)")
    procs, end = tp_check.start_ranks(tp_check.routes_main,
                                      lambda r: (r, WORLD, str(tmp_path / "store"),
                                                 str(tmp_path / f"rank{r}.pkl")),
                                      WORLD, DEADLINE)
    err = tp_check.wait_ranks(procs, end)
    assert err is None, err
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            res = pickle.load(f)
        assert set(res) == {"all_reduce", "all_gather", "broadcast"}, res
        for op, (route, err, err_staged) in res.items():
            assert route in ("direct", "host") and (err, err_staged) == (0.0, 0.0), (r, op, res)
        print(f"rank {r}: {res}")
