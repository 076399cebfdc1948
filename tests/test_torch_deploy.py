"""The port's deploy files (module 11): `Dockerfile.cuda` and
`kubernetes/jlama-tpu-torch.yaml`, the counterparts of `Dockerfile` and
`kubernetes/jlama-tpu.yaml`. Neither is built or applied here (no network,
no cluster): the manifest parses, its pods run the port's command line with
options its `serve` parser takes (the StatefulSet's shell loop expanded for
each rank of the default env), the ranks cover the mesh once each, the
resources are NVIDIA GPUs, and neither file names JAX, libtpu or a TPU.
"""

import re
import shlex
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parent.parent
DOCKERFILE = ROOT / "Dockerfile.cuda"
MANIFEST = ROOT / "kubernetes" / "jlama-tpu-torch.yaml"
TPU_WORDS = re.compile(r"\bjax\b|libtpu|\btpu[-_ ]v|google\.com/tpu|gke-tpu|\bTPU\b",
                       re.IGNORECASE)


def _docs():
    return list(yaml.safe_load_all(MANIFEST.read_text()))


def _server():
    sts = next(d for d in _docs() if d["kind"] == "StatefulSet")
    return sts, sts["spec"]["template"]["spec"]["containers"][0]


def _rank_argvs() -> list[list[str]]:
    """Each rank's `serve` argv: the container's loop run by hand for every
    pod ordinal and GPU, from the manifest's env."""
    sts, c = _server()
    env = {e["name"]: e["value"] for e in c["env"]}
    hosts, gpus = int(env["NUM_HOSTS"]), int(env["GPUS_PER_POD"])
    assert sts["spec"]["replicas"] == hosts
    script = c["args"][0]
    body = script[script.index("do ") + 3:script.index(" &")]
    out = []
    for ordinal in range(hosts):
        for i in range(gpus):
            line = body
            for k, v in env.items():
                line = line.replace(f'"${k}"', shlex.quote(v))
            line = line.replace("$((NUM_HOSTS * GPUS_PER_POD))", str(hosts * gpus))
            line = line.replace("$((ORDINAL * GPUS_PER_POD + i))", str(ordinal * gpus + i))
            line = line.replace("$i", str(i))
            assert "$" not in line, line
            out.append(shlex.split(line))
    return out


def test_manifest_parses_and_wires_the_statefulset_to_its_service():
    docs = _docs()
    svc = next(d for d in docs if d["kind"] == "Service")
    sts, c = _server()
    assert svc["spec"]["clusterIP"] == "None"
    assert sts["spec"]["serviceName"] == svc["metadata"]["name"]
    assert svc["spec"]["selector"] == sts["spec"]["template"]["metadata"]["labels"]
    ports = {p["name"]: p["port"] for p in svc["spec"]["ports"]}
    assert ports == {"api": 8080, "coordinator": 8476, "step-broadcast": 9476}
    gpus = int({e["name"]: e["value"] for e in c["env"]}["GPUS_PER_POD"])
    for kind in ("requests", "limits"):
        assert c["resources"][kind] == {"nvidia.com/gpu": gpus}


def test_every_rank_runs_serve_with_the_ports_options():
    """The entry command is the port's CLI, and its `serve` parser takes
    every option each rank is given (argparse exits on one it does not
    know); the ranks are 0 .. world - 1 once each, world = dp * pp * tp."""
    from jlama_tpu_torch.cli import build_parser

    argvs = _rank_argvs()
    ranks = []
    for argv in argvs:
        assert argv[:3] == ["python", "-m", "jlama_tpu_torch.cli"]
        args = build_parser().parse_args(argv[3:])
        assert args.cmd == "serve" and args.fn.__name__ == "cmd_serve"
        dp, pp, tp = (int(x) for x in args.mesh.split(","))
        assert args.num_processes == dp * pp * tp == len(argvs)
        assert args.coordinator == "jlama-tpu-torch-0.jlama-tpu-torch:8476"
        assert (args.step_port, args.port) == (9476, 8080)
        assert args.device == f"cuda:{args.process_id % 8}"
        ranks.append(args.process_id)
    assert sorted(ranks) == list(range(len(argvs)))


def test_dockerfile_runs_the_ports_cli_and_builds_nothing_of_jax():
    text = DOCKERFILE.read_text()
    assert re.search(r'^ENTRYPOINT \["python", "-m", "jlama_tpu_torch\.cli"\]$', text, re.M)
    assert re.search(r"^FROM nvidia/cuda:\S+-devel-", text, re.M)  # nvcc for the kernels
    assert "COPY jlama_tpu_torch ./jlama_tpu_torch" in text
    assert "jlama_tpu_torch/_build" in text
    installs = " ".join(line for line in text.splitlines() if "pip install" in line)
    for pkg in ("jax", "libtpu", "regex", "jinja2", "aiohttp"):
        assert pkg not in installs, pkg
    assert "torch" in installs and "numpy" in installs


@pytest.mark.parametrize("path", [DOCKERFILE, MANIFEST], ids=lambda p: p.name)
def test_no_jax_libtpu_or_tpu(path):
    # the image and the manifest are for GPUs: nothing of the JAX package's
    # platform (their names are the project's, jlama-tpu)
    text = path.read_text().replace("jlama-tpu", "").replace("jlama_tpu", "")
    assert not TPU_WORDS.search(text), TPU_WORDS.search(text).group(0)
