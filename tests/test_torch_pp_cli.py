"""`python -m jlama_tpu_torch.cli serve --mesh 1,2,1 --device cpu` with rank 0
started alone (`--num-processes 2`: it starts rank 1 itself on a file store
of its own): through the pp ring (the PipelinedScheduler), and with
`--no-pp-pipeline` (the stage-serial BatchScheduler). Both servers start
together; each answers one greedy chat completion as an in-process
single-device BatchScheduler does on the same prompt ids. The ring's server
rounds `--batch-slots 3` to 2 and warns that `--itl-budget-ms` is ignored,
with the JAX CLI's messages; the stage-serial one takes both as given. All
processes are stopped by their PIDs."""

import os
import re
import signal
import subprocess
import sys
import time

import pytest

from tests.helpers import make_tiny_chat_model
from tests.test_torch_tp_cli import DEADLINE, ROOT, _ask, _one_device_answer

SERVE = ["--device", "cpu", "--batch-slots", "3", "--kv-pages", "32", "--page-size", "8",
         "--context", "64", "--kv-dtype", "f32", "--working-dtype", "f32",
         "--itl-budget-ms", "50"]
MODES = {"ring": [], "serial": ["--no-pp-pipeline"]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each mode's answer and rank 0's output lines, and one device's answer."""
    tmp = tmp_path_factory.mktemp("pp_cli")
    model_dir, _ = make_tiny_chat_model(tmp / "model")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT), TMPDIR=str(tmp))
    leads = {m: subprocess.Popen(
        [sys.executable, "-m", "jlama_tpu_torch.cli", "serve", str(model_dir), "--mesh",
         "1,2,1", "--num-processes", "2", "--host", "127.0.0.1", "--port", "0", *SERVE,
         *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for m, extra in MODES.items()}
    end = time.monotonic() + DEADLINE
    got, started = {}, []
    try:
        for m, lead in leads.items():
            got[m] = _ask(lead, end)
            started += [int(x.group(1)) for s in got[m][1]
                        for x in [re.search(r"started rank 1/2 \(pid (\d+)\)", s)] if x]
    finally:
        for pid in [p.pid for p in leads.values()] + started:  # stopped by PID
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in leads.values():
            p.wait(10)
    return got, _one_device_answer(model_dir), started


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_pp_mesh_answers_as_one_device(served, mode):
    """Each server's greedy answer equals one device's; rank 0 is stage 0 of
    the ring and started rank 1."""
    got, want, started = served
    text, seen = got[mode]
    assert text == want
    assert any("(dp group 0, stage 0, tp rank 0)" in s for s in seen), "".join(seen)
    assert len(started) == 2


def test_ring_rounds_slots_and_ignores_the_itl_budget(served):
    """The JAX CLI's messages (`jlama_tpu/cli.py:267-289`): the slots rounded
    to a multiple of pp, the rows a microbatch, the budget ignored on the
    ring; the stage-serial scheduler prints none of them."""
    got, _, _ = served
    ring, serial = "".join(got["ring"][1]), "".join(got["serial"][1])
    assert "batch-slots rounded to 2 (divisible by pp)" in ring
    assert "pp=2 pipeline decode enabled (1 rows/microbatch)" in ring
    assert "warning: --itl-budget-ms is ignored on the pp pipeline path" in ring
    for msg in ("batch-slots rounded", "pipeline decode enabled", "--itl-budget-ms"):
        assert msg not in serial


def test_ranks_told_to_share_a_gpu_take_gloo():
    """`--device cuda:N` on a host of one GPU puts every rank on it, which
    NCCL refuses: those ranks join over gloo. On a host of several GPUs it
    keeps NCCL, whose device check then refuses two ranks on one GPU; any
    other device keeps its default backend (NCCL on cuda:rank, gloo on the
    CPU)."""
    from jlama_tpu_torch.cli import _shared_gpu_backend
    from jlama_tpu_torch.parallel.distributed import check_nccl_devices

    assert _shared_gpu_backend("cuda:0", device_count=1) == "gloo"
    assert _shared_gpu_backend("cuda:0", device_count=4) is None
    with pytest.raises(ValueError, match="two ranks share h/cuda:0"):
        check_nccl_devices(["h/cuda:0", "h/cuda:0"], 4)
    assert [_shared_gpu_backend(d, device_count=1) for d in (None, "cuda", "cpu")] == \
        [None, None, None]
