#!/usr/bin/env python3
"""Smoke run of the GoldRush engine and pipeline on NVIDIA GPUs.

    python chip_smoke.py           # one card: the device, parity, scale,
                                   # pipeline and gpu-tests phases
    python chip_smoke.py --four    # four cards: the multi-device engine
                                   # runs and the one-card run they are
                                   # compared with, nothing else

Every dataset is generated from seeds by ``goldrush_jax.utils.synth``;
nothing is downloaded.  The engine and the pipeline are integer-only, so a
run on the GPU must write exactly the bytes the same run writes on the
CPU.  The CPU runs are the plain reference (the CPU engine's parity with
the compiled reference binary is tests/test_ref_parity.py); they happen in
child processes started with JAX_PLATFORMS=cpu, which never open the card,
so this process is the only one that uses it.

No phase's failure is caught: any of them raises and the script exits
nonzero.  Numbers printed here are smoke numbers, not benchmark numbers.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# parity and pipeline dataset: the shape of tests/test_ref_parity.py
PARITY = dict(G=1_000_000, window=1_000_000, n_reads=500, read_len=22_000,
              genome_seed=21, read_seed=22)
# scale dataset: a C. elegans-sized genome (the filter is sized from G:
# ~2.85e9 slots, words + counts ~22.8 GB on the card, int64 slot indices);
# the reads cover its first 10 Mbp 3x.  The per-read recruit scan runs at
# ~28 reads/s on one H100, so 1,500 reads (not 6,000 at 12x) is what lets
# both scale runs and the other phases finish inside 1200 s.
SCALE = dict(G=100_000_000, window=10_000_000, n_reads=1_500,
             read_len=20_000, genome_seed=31, read_seed=32)
# --four: the scale genome and filter (what banking splits) with fewer
# reads: six silver-path engine runs on four cards.  The exact-mode half
# took 157 s on four H100s at this size
FOUR_READS = 100

# the sampled throughput setting bench.py ships; API-only (PathConfig)
THROUGHPUT = dict(frame_stride=8, probe_seeds=1, mibf_mode="compressed",
                  recheck="optimistic", batch_reads=64)
# parity modes: a list is extra `goldrush-path` CLI parameters, a dict is
# PathConfig overrides for the engine API
MODES = {
    "exact": [],
    "stride8": ["frame_stride=8", "probe_seeds=1"],
    "compressed": THROUGHPUT,
    "wavefront": {**THROUGHPUT, "wavefront": True},
}
# the pipeline phase runs silver -> golden -> polish.  The full `run` (with
# tigmint, ntLink and targeted polish) writes the same bytes on the GPU as
# on the CPU too, but its GPU run alone took 826 s on one H100, compiling
# 323 executables, which leaves no room for the other phases in 1200 s
PIPELINE_CMD = "path-polish"

_STAGE = re.compile(r"^\[goldrush-jax\] ([^:]+): ([0-9.]+)s$")
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"
CACHE_HIT_EVENT = "/jax/compilation_cache/cache_hits"


# --------------------------------------------------------------- helpers
def result_line(device: dict) -> str:
    """The last line: platform, kind and count exactly as JAX reports."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def write_reads(path: str, G: int, window: int, n_reads: int,
                read_len: int, genome_seed: int, read_seed: int) -> None:
    """FASTQ of 5%-error reads drawn from the first ``window`` bases of a
    seeded G-base genome."""
    from goldrush_jax.utils import synth
    genome = synth.random_genome(G, seed=genome_seed)[:window]
    synth.write_fastq(path, synth.simulate_reads(
        genome, n_reads, read_len, seed=read_seed, err_rate=0.05))


def fastq_bases(path: str) -> int:
    with open(path, "rb") as f:
        return sum(len(line) - 1 for i, line in enumerate(f) if i % 4 == 1)


def stage_times(log: str) -> dict:
    """Seconds per pipeline stage, from the pipeline's log lines."""
    out = {}
    with open(log) as f:
        for line in f:
            m = _STAGE.match(line.strip())
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def compare_trees(a: str, b: str) -> tuple[int, int]:
    """Require the same regular files (symlinks aside) with the same bytes
    under ``a`` and ``b``; returns (files, bytes)."""
    def tree(root):
        out = {}
        for d, _, names in os.walk(root):
            for n in names:
                p = os.path.join(d, n)
                if not os.path.islink(p):
                    out[os.path.relpath(p, root)] = p
        return out
    ta, tb = tree(a), tree(b)
    if sorted(ta) != sorted(tb):
        raise AssertionError(
            f"file sets differ: only in {a}: {sorted(set(ta) - set(tb))}, "
            f"only in {b}: {sorted(set(tb) - set(ta))}")
    if not ta:
        raise AssertionError(f"no output files under {a}")
    nbytes = 0
    for rel in sorted(ta):
        with open(ta[rel], "rb") as fa, open(tb[rel], "rb") as fb:
            da, db = fa.read(), fb.read()
        if da != db:
            raise AssertionError(f"{rel} differs: {len(da)} vs {len(db)} "
                                 f"bytes")
        nbytes += len(da)
    return len(ta), nbytes


@contextlib.contextmanager
def _in_dir(path: str):
    """Run with ``path`` as the working directory and stdout sent to
    ``path + '.log'``."""
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        with open(path + ".log", "w") as log, \
                contextlib.redirect_stdout(log):
            yield
    finally:
        os.chdir(cwd)


def run_cli(argv: list[str], workdir: str) -> dict:
    """``python -m goldrush_jax.cli <argv>`` in-process, from ``workdir``;
    returns the seconds per stage."""
    from goldrush_jax import cli
    with _in_dir(workdir):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return stage_times(workdir + ".log")


def run_api(reads: str, workdir: str, G: int, over: dict) -> dict:
    """Silver then golden pass through the engine API with PathConfig
    overrides, written like the pipeline writes them."""
    from goldrush_jax.config import PipelineConfig, stage_filenames
    from goldrush_jax.path.engine import GoldenPathEngine
    cfg = PipelineConfig(G=G)
    files = stage_filenames(cfg)
    times = {}
    with _in_dir(workdir):
        for silver in (True, False):
            pc = dataclasses.replace(
                cfg.path_config(silver),
                input=reads if silver else files["silver_all"], **over)
            t0 = time.time()
            GoldenPathEngine(pc).run()
            times["silver" if silver else "golden"] = time.time() - t0
            if silver:
                with open(files["silver_all"], "wb") as out:
                    for f in files["silver"]:
                        if os.path.exists(f):
                            with open(f, "rb") as src:
                                out.write(src.read())
    return times


def run_mode(mode: str, reads: str, workdir: str, G: int) -> dict:
    """One parity mode (a key of MODES): silver and golden paths into
    ``workdir``, kept (dev=1) so all of them are compared."""
    over = MODES[mode]
    if isinstance(over, list):
        return run_cli(["goldrush-path", f"reads={reads[:-3]}", f"G={G}",
                        "dev=1", f"prefix={workdir}", *over], workdir)
    return run_api(reads, workdir, G, over)


def run_pipeline(reads: str, workdir: str, G: int) -> dict:
    """The pipeline through PIPELINE_CMD, every stage output kept."""
    return run_cli([PIPELINE_CMD, f"reads={reads[:-3]}", f"G={G}", "dev=1",
                    f"prefix={workdir}"], workdir)


# ------------------------------------------------ CPU reference children
def cpu_parity(reads: str, out: str, G: int, modes: list[str]) -> None:
    """Child-process entry: the parity modes on the CPU."""
    for mode in modes:
        run_mode(mode, reads, os.path.join(out, mode), G)


def cpu_pipeline(reads: str, out: str, G: int) -> None:
    """Child-process entry: the pipeline on the CPU."""
    run_pipeline(reads, out, G)


def spawn(fn: str, *args, log: str, **kwargs) -> subprocess.Popen:
    """Start ``chip_smoke.<fn>(*args, **kwargs)`` in a CPU-only child
    process; its output goes to ``log``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    code = f"import chip_smoke; chip_smoke.{fn}(*{args!r}, **{kwargs!r})"
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                                env=env, stdout=f, stderr=subprocess.STDOUT)


def wait(proc: subprocess.Popen, log: str, what: str,
         timeout: float = 1100) -> None:
    rc = proc.wait(timeout=timeout)
    if rc != 0:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{what} failed with exit code {rc}:\n{tail}")


class Compiles:
    """Counts executables built (XLA compiles plus persistent-cache
    loads) and persistent-cache hits, from JAX's monitoring events."""

    def __init__(self):
        self.built = self.hits = 0
        import jax.monitoring as mon
        mon.register_event_duration_secs_listener(self._duration)
        mon.register_event_listener(self._event)

    def _duration(self, event, _secs, **_kw):
        if event == COMPILE_EVENT:
            self.built += 1

    def _event(self, event, **_kw):
        if event == CACHE_HIT_EVENT:
            self.hits += 1

    def snapshot(self) -> tuple[int, int]:
        return self.built, self.hits


@contextlib.contextmanager
def recording_engines():
    """Collect (params, stats) of every engine the pipeline runs."""
    from goldrush_jax import pipeline
    base = pipeline.GoldenPathEngine
    runs = []

    class Recorded(base):
        def run(self, *a, **kw):
            stats = super().run(*a, **kw)
            runs.append((self.params, stats))
            return stats

    pipeline.GoldenPathEngine = Recorded
    try:
        yield runs
    finally:
        pipeline.GoldenPathEngine = base


def peak_bytes(dev) -> int:
    """The device allocator's peak over this process's lifetime."""
    return dev.memory_stats()["peak_bytes_in_use"]


def _elapsed(t0: float) -> str:
    return f"{time.time() - t0:.1f} s"


# ---------------------------------------------------------------- phases
def phase_device(need: int) -> list[str]:
    import jax
    from goldrush_jax.io.native_reader import native_available
    from goldrush_jax.utils import device
    devs = device.require_gpu()
    if len(devs) < need:
        raise SystemExit(f"needs {need} GPUs; JAX sees {len(devs)}")
    print(f"[device] {devs[0].device_kind}, {len(devs)} device(s), "
          f"jax {jax.__version__}")
    cards = device.cards()
    for card in cards:
        print(card)
    print(f"[device] compile cache: {jax.config.jax_compilation_cache_dir}")
    print(f"[device] FASTQ reader: "
          f"{'native' if native_available() else 'python'}")
    return cards


def phase_parity(reads: str, gpu_dir: str, ref, ref_dir: str) -> None:
    for mode in MODES:
        t0 = time.time()
        run_mode(mode, reads, os.path.join(gpu_dir, mode), PARITY["G"])
        print(f"[parity] {mode}: GPU silver + golden in {_elapsed(t0)}")
    t0 = time.time()
    wait(*ref, "CPU parity reference")
    print(f"[parity] waited {_elapsed(t0)} for the CPU reference")
    for mode in MODES:
        n, b = compare_trees(os.path.join(gpu_dir, mode),
                             os.path.join(ref_dir, mode))
        print(f"[parity] {mode}: {n} files, {b} bytes identical on GPU "
              f"and CPU")


def phase_pipeline(reads: str, gpu_dir: str, ref, ref_dir: str,
                   compiles: Compiles) -> None:
    t0 = time.time()
    built0, hits0 = compiles.snapshot()
    gpu = run_pipeline(reads, gpu_dir, PARITY["G"])
    built, hits = compiles.snapshot()
    print(f"[pipeline] GPU run in {_elapsed(t0)}, executables built "
          f"{built - built0} (persistent-cache hits {hits - hits0})")
    t0 = time.time()
    wait(*ref, "CPU pipeline reference")
    print(f"[pipeline] waited {_elapsed(t0)} for the CPU reference")
    cpu = stage_times(ref_dir + ".log")
    for stage in gpu:
        print(f"[pipeline] {stage}: GPU {gpu[stage]:.1f} s, "
              f"CPU {cpu.get(stage, float('nan')):.1f} s")
    n, b = compare_trees(gpu_dir, ref_dir)
    print(f"[pipeline] {n} stage files, {b} bytes identical on GPU and CPU")


def phase_scale(reads: str, work: str, card: str, compiles: Compiles
                ) -> None:
    import jax
    from goldrush_jax.config import PipelineConfig, stage_filenames
    from goldrush_jax.io import fastq
    read_bases = fastq_bases(reads)
    golden_name = stage_filenames(PipelineConfig())["golden"]
    for mode in ("exact", "stride8"):
        extra = MODES[mode]
        wd = os.path.join(work, mode)
        built0, hits0 = compiles.snapshot()
        t0 = time.time()
        with recording_engines() as runs:
            run_cli(["goldrush-path", f"reads={reads[:-3]}",
                     f"G={SCALE['G']}", f"prefix={wd}", *extra], wd)
        wall = time.time() - t0
        built, hits = compiles.snapshot()
        (params, silver), (_, golden) = runs
        golden_bases = sum(len(r.seq) for r in fastq.read_records(
            os.path.join(wd, golden_name)))
        recruits = silver.recruits + golden.recruits
        peak = peak_bytes(jax.devices()[0])
        print(f"[scale] {mode} (smoke numbers, not a benchmark; {card}): "
              f"filter {params.alloc * 8} B ({params.size} slots), "
              f"process peak_bytes_in_use {peak} B, wall {wall:.1f} s")
        for name, st in (("silver", silver), ("golden", golden)):
            print(f"[scale] {mode} {name}: fill_s {st.wall_fill_s:.3f}, "
                  f"assign_s {st.wall_assign_s:.3f}, submit_s "
                  f"{st.wall_submit_s:.3f}, reads {st.num_reads}, reads/s "
                  f"{st.num_reads / max(st.wall_assign_s, 1e-9):.2f}, "
                  f"recruits {st.recruits}")
        print(f"[scale] {mode}: executables built {built - built0} "
              f"(persistent-cache hits {hits - hits0}); golden path "
              f"{golden_bases} bases of {read_bases} read bases")
        if recruits <= 0:
            raise AssertionError(f"scale {mode}: no recruits")
        if not (0.5 * SCALE["window"] <= golden_bases <= read_bases):
            raise AssertionError(
                f"scale {mode}: golden path holds {golden_bases} bases; "
                f"want [{0.5 * SCALE['window']:.0f}, {read_bases}]")


def phase_gpu_tests() -> None:
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(REPO, "tests")])
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")


def phase_four(work: str, card: str) -> None:
    """Data-parallel (devices=4) and banked (devices=4, model_shards=4)
    silver-path engine runs against one card, exact and throughput."""
    import jax
    from goldrush_jax.config import PipelineConfig
    from goldrush_jax.path.engine import GoldenPathEngine
    reads = os.path.join(work, "four.fq")
    write_reads(reads, **{**SCALE, "n_reads": FOUR_READS})
    base = PipelineConfig(G=SCALE["G"]).path_config(silver=True)
    modes = {"exact": {}, "throughput": dict(
        frame_stride=8, probe_seeds=1, recheck="optimistic")}
    # banked first: peak_bytes_in_use is a process-lifetime peak, so only
    # runs before any replicated filter show the banked split
    layouts = {"banked4": dict(devices=4, model_shards=4),
               "dp4": dict(devices=4), "single": {}}
    for mode, over in modes.items():
        outs = {}
        for layout, kw in layouts.items():
            out = os.path.join(work, mode, layout)
            cfg = dataclasses.replace(base, input=reads, prefix_file="silver",
                                      **over, **kw)
            t0 = time.time()
            with _in_dir(out):
                st = GoldenPathEngine(cfg).run()
            peaks = [peak_bytes(d) for d in jax.devices()]
            print(f"[four] {mode} {layout} ({card}): wall {_elapsed(t0)}, "
                  f"fill_s {st.wall_fill_s:.3f}, assign_s "
                  f"{st.wall_assign_s:.3f}, recruits {st.recruits}, "
                  f"per-device peak_bytes_in_use {peaks}")
            outs[layout] = out
        for layout in ("banked4", "dp4"):
            n, b = compare_trees(outs[layout], outs["single"])
            print(f"[four] {mode} {layout}: {n} silver files, {b} bytes "
                  f"identical to one card")


# ------------------------------------------------------------------ main
def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Smoke run of the engine and pipeline on NVIDIA GPUs.")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card engine comparison")
    args = ap.parse_args(argv)
    # a terminated run still stops its children (the finally below)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    from goldrush_jax.utils import device
    t_start = time.time()
    cards = phase_device(4 if args.four else 1)
    compiles = Compiles()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    procs = []
    try:
        if args.four:
            phase_four(work, "; ".join(cards))
        else:
            parity_fq = os.path.join(work, "parity.fq")
            scale_fq = os.path.join(work, "scale.fq")
            ref = os.path.join(work, "cpu")
            scale_w = spawn("write_reads", scale_fq, log=scale_fq + ".log",
                            **SCALE)
            procs.append(scale_w)
            write_reads(parity_fq, **PARITY)
            par_log = os.path.join(work, "cpu_parity.log")
            pipe_log = os.path.join(work, "cpu_pipeline.log")
            procs.append(spawn("cpu_parity", parity_fq,
                               os.path.join(ref, "parity"), PARITY["G"],
                               list(MODES), log=par_log))
            procs.append(spawn("cpu_pipeline", parity_fq,
                               os.path.join(ref, "pipeline"), PARITY["G"],
                               log=pipe_log))
            t0 = time.time()
            phase_parity(parity_fq, os.path.join(work, "gpu", "parity"),
                         (procs[1], par_log), os.path.join(ref, "parity"))
            print(f"[parity] ok in {_elapsed(t0)}")
            t0 = time.time()
            wait(scale_w, scale_fq + ".log", "scale dataset writer")
            phase_scale(scale_fq, os.path.join(work, "scale"), cards[0],
                        compiles)
            print(f"[scale] ok in {_elapsed(t0)}")
            t0 = time.time()
            phase_pipeline(parity_fq, os.path.join(work, "gpu", "pipeline"),
                           (procs[2], pipe_log),
                           os.path.join(ref, "pipeline"), compiles)
            print(f"[pipeline] ok in {_elapsed(t0)}")
            t0 = time.time()
            phase_gpu_tests()
            print(f"[gpu-tests] ok in {_elapsed(t0)}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(f"[done] all phases in {_elapsed(t_start)}")
    print(result_line(device.jax_device()))


if __name__ == "__main__":
    main()
