"""chip_smoke.py: its CPU-side helpers here, its parity phase on the card.

The ``gpu`` tests run the parity phase's functions on the GPU and compare
their outputs byte for byte with the same functions run by a CPU-only
child process; they skip unless JAX's first device is a GPU."""

import json
import os
import subprocess
import sys

import pytest

from tests.conftest import REPO

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

# small parity dataset: the parity genome with 40 reads
SMALL = dict(chip_smoke.PARITY, n_reads=40, read_seed=42)
# one mode through the CLI, one through the engine API (the smoke's parity
# phase covers all four at full size)
GPU_MODES = ["exact", "wavefront"]


def test_device_gate_exits_nonzero_on_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_script_alone_exits_nonzero(tmp_path):
    """Outside the repo (chip_smoke.py and nothing else) it cannot run."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""


def test_result_line_is_exact():
    line = chip_smoke.result_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
         "cards": ["ignored"]})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def _tree(root, files):
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)


def test_compare_trees(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    files = {"x.fq": b"@r\nACGT\n+\nIIII\n", "sub/y.fa": b">c\nAC\n"}
    _tree(a, files)
    _tree(b, files)
    os.symlink(a / "x.fq", b / "link.fq")        # symlinks are not outputs
    assert chip_smoke.compare_trees(str(a), str(b)) == (2, 21)
    (b / "sub" / "y.fa").write_bytes(b">c\nAG\n")
    with pytest.raises(AssertionError, match="y.fa differs"):
        chip_smoke.compare_trees(str(a), str(b))
    (b / "sub" / "y.fa").unlink()
    with pytest.raises(AssertionError, match="file sets differ"):
        chip_smoke.compare_trees(str(a), str(b))
    empty = tmp_path / "e"
    empty.mkdir()
    with pytest.raises(AssertionError, match="no output files"):
        chip_smoke.compare_trees(str(empty), str(empty))


def test_stage_times(tmp_path):
    log = tmp_path / "run.log"
    log.write_text("[goldrush-jax] goldrush-path (silver): 13.2s\n"
                   "[goldrush-jax] polish edits: 20639\n"
                   "[goldrush-jax] polish: 533.7s\n"
                   "[goldrush-jax] final assembly: {'n': 4} (9.9s total)\n")
    assert chip_smoke.stage_times(str(log)) == {
        "goldrush-path (silver)": 13.2, "polish": 533.7}


def test_fastq_bases(tmp_path):
    p = tmp_path / "r.fq"
    p.write_bytes(b"@a\nACGT\n+\nIIII\n@b\nAC\n+\nII\n")
    assert chip_smoke.fastq_bases(str(p)) == 6


@pytest.mark.parametrize("mode", ["stride8", "compressed"])
def test_run_mode_writes_same_bytes_twice(tmp_path, mode):
    """A parity mode (one CLI mode, one API mode) at a tiny size on the
    CPU: its silver and golden paths come out, and a rerun matches."""
    reads = str(tmp_path / "r.fq")
    chip_smoke.write_reads(reads, **dict(SMALL, n_reads=24))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    times = chip_smoke.run_mode(mode, reads, a, SMALL["G"])
    chip_smoke.run_mode(mode, reads, b, SMALL["G"])
    assert times
    n, nbytes = chip_smoke.compare_trees(a, b)
    assert n >= 2 and nbytes > 0


@pytest.fixture(scope="module")
def cpu_reference(gpu, tmp_path_factory):
    """The parity modes on the small dataset, run by a CPU-only child."""
    d = tmp_path_factory.mktemp("smoke_parity")
    reads = str(d / "reads.fq")
    chip_smoke.write_reads(reads, **SMALL)
    log = str(d / "cpu.log")
    proc = chip_smoke.spawn("cpu_parity", reads, str(d / "cpu"),
                            SMALL["G"], GPU_MODES, log=log)
    chip_smoke.wait(proc, log, "CPU parity reference", timeout=900)
    return reads, d


@pytest.mark.gpu
@pytest.mark.parametrize("mode", GPU_MODES)
def test_parity_mode_gpu_matches_cpu(gpu, cpu_reference, mode):
    reads, d = cpu_reference
    out = str(d / "gpu" / mode)
    chip_smoke.run_mode(mode, reads, out, SMALL["G"])
    n, nbytes = chip_smoke.compare_trees(out, str(d / "cpu" / mode))
    assert n >= 2 and nbytes > 0
