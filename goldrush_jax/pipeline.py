"""Pipeline orchestrator: the 5-stage GoldRush flow with make-style resume.

Replaces the GNU-make driver (bin/goldrush:209-308): every stage writes a
file whose name encodes its parameters (stage_filenames), a stage is skipped
when its output already exists (the reference's .SECONDARY/.DELETE_ON_ERROR
resume semantics), and partial outputs are removed on failure.

Stage chain (bin/goldrush:220-224):
  silver paths -> concat -> golden path -> polish -> tigmint -> ntLink x rounds
  -> targeted polish
"""

from __future__ import annotations

import json
import os
import time

from .config import PipelineConfig, stage_filenames
from .io import fastq
from .path.engine import GoldenPathEngine
from .stages import ntlink, polish, targeted, tigmint
from .utils.stats import assembly_stats


def _log(msg: str) -> None:
    print(msg, flush=True)


def _atomic_stage(path: str):
    """Context manager: write stage output under a temp name, rename on
    success, delete on failure (.DELETE_ON_ERROR equivalent)."""
    class _Ctx:
        def __init__(self, final):
            self.final = final
            self.tmp = final + ".partial"

        def __enter__(self):
            return self.tmp

        def __exit__(self, et, ev, tb):
            if et is None:
                os.replace(self.tmp, self.final)
            elif os.path.exists(self.tmp):
                os.remove(self.tmp)
            return False
    return _Ctx(path)


def _read_fasta(path: str) -> list[tuple[str, bytes]]:
    return [(r.id, r.seq) for r in fastq.read_records(path)]


def _load_reads(path: str) -> list[bytes]:
    return [r.seq for r in fastq.read_records(path)]


def run_pipeline(cfg: PipelineConfig, workdir: str = ".",
                 until: str = "final", frame_stride: int = 1,
                 probe_seeds: int = 0, engine_extra: dict | None = None
                 ) -> dict:
    """Run the pipeline up to stage `until` (one of: silver, golden,
    polished, tigmint, ntlink, final).  Returns stage->path map.
    ``engine_extra`` (save_mibf/load_mibf/trace_dir) applies to the first
    goldrush-path stage that runs."""
    t_start = time.time()
    cwd = os.getcwd()
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    try:
        return _run(cfg, until, frame_stride, probe_seeds, t_start,
                    engine_extra or {})
    finally:
        os.chdir(cwd)


def _run(cfg: PipelineConfig, until: str, frame_stride: int,
         probe_seeds: int, t_start: float, engine_extra: dict) -> dict:
    files = stage_filenames(cfg)
    reads_file = None
    for ext in (".fq", ".fastq", ".fq.gz", ".fastq.gz"):
        if os.path.exists(cfg.reads + ext):
            reads_file = cfg.reads + ext
            break
    if reads_file is None:
        raise FileNotFoundError(
            f"Reads file not found. Expected {cfg.reads}.fq or "
            f"{cfg.reads}.fastq")
    if not cfg.G:
        raise ValueError("G is a required parameter")
    order = ["silver", "golden", "polished", "tigmint", "ntlink", "final"]
    stop = order.index(until)

    def stage_time(name, fn, out_path=None):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        _log(f"[goldrush-jax] {name}: {dt:.1f}s")
        if cfg.track_time and out_path:
            # track_time=1 parity (bin/goldrush:116-129: GNU time -v per
            # stage into <target>.time); in-process equivalent records wall
            # seconds and the process peak RSS so far
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            with open(out_path + ".time", "w") as f:
                f.write(f"stage\t{name}\nwall_s\t{dt:.2f}\n"
                        f"peak_rss_kb\t{peak}\n")
        return out

    # --- stage 1: silver paths (goldrush-path --silver_path) -------------
    # skipped entirely when the golden path already exists: dev=False
    # cleanup removes the silver intermediates after the golden pass, and a
    # resume must not rebuild them (.SECONDARY semantics, bin/goldrush:133)
    last_silver = files["silver"][-1]
    # until="silver" explicitly requests the silver output: rebuild it even
    # when a later dev=False run already produced the golden path and
    # removed the silver intermediates (returning the recorded path would
    # otherwise dangle at a deleted file)
    want_silver = stop == order.index("silver")
    if not os.path.exists(files["silver_all"]) and \
            (want_silver or not os.path.exists(files["golden"])):
        if not os.path.exists(last_silver):
            def silver():
                pc = cfg.path_config(silver=True)
                pc.input = reads_file
                pc.frame_stride = frame_stride
                pc.probe_seeds = probe_seeds
                for k, v in engine_extra.items():
                    setattr(pc, k, v)
                eng = GoldenPathEngine(pc)
                eng.run()
            stage_time("goldrush-path (silver)", silver, last_silver)
        with _atomic_stage(files["silver_all"]) as tmp:
            with open(tmp, "wb") as out:
                for f in files["silver"]:
                    if os.path.exists(f):
                        out.write(open(f, "rb").read())
    if stop <= order.index("silver"):
        return {"silver_all": files["silver_all"]}

    # --- stage 2: golden path --------------------------------------------
    if not os.path.exists(files["golden"]):
        def golden():
            pc = cfg.path_config(silver=False)
            pc.input = files["silver_all"]
            pc.frame_stride = frame_stride
            pc.probe_seeds = probe_seeds
            eng = GoldenPathEngine(pc)
            eng.run()
        stage_time("goldrush-path (golden)", golden, files["golden"])
        # clean: the silver .fq files (per-path AND the _all concat) are
        # intermediates once the golden pass consumed them — removed unless
        # dev=True keeps them for debugging (rm -f $(p1)_*.fq,
        # bin/goldrush:202-206)
        if not cfg.dev:
            for f in files["silver"] + [files["silver_all"]]:
                if os.path.exists(f):
                    os.remove(f)
    if stop <= order.index("golden"):
        return {"golden": files["golden"]}

    # --- stage 3: polish (GoldPolish equivalent, or racon-equivalent when
    # polisher=racon — bin/goldrush:262-277) ------------------------------
    if not os.path.exists(files["polished"]):
        def do_polish():
            contigs = _read_fasta(files["golden"])
            # bounded-memory path: above this input size (or when forced
            # via GOLDRUSH_POLISH_STREAM_BYTES) the k-mer polisher streams
            # reads from disk in chunks and spills per-goldtig read sets
            # to temp files instead of holding every read in memory —
            # identical output, O(index + chunk + one goldtig's reads)
            # peak (the reference's envelope at 67x human scale,
            # /root/reference/README.md:121)
            stream_bytes = int(os.environ.get(
                "GOLDRUSH_POLISH_STREAM_BYTES", str(2 << 30)))
            streaming = (cfg.polisher != "racon"
                         and os.path.getsize(reads_file) >= stream_bytes)
            reads = None if streaming else _load_reads(reads_file)
            if cfg.polisher == "racon":
                from .stages import racon
                out, edits = racon.polish_with_racon(contigs, reads)
            else:
                # polisher_mapper picks the read->goldtig assignment mapping
                # (goldpolish --minimap2 vs --ntlink --k-ntlink
                # $(polish_k) --w-ntlink $(polish_w), bin/goldrush:35-41)
                if cfg.polisher_mapper == "ntlink":
                    mk, mw = min(32, cfg.polish_k), cfg.polish_w
                else:
                    mk, mw = 15, 10
                # large-k-then-small-k schedule with a final large-k refine
                # cycle: the large k is specific, the smaller ks stay solid
                # where ONT error thins large-k read support and separate
                # merged absent regions so dense indel clusters localize.
                # site_spacing=2 emits a candidate at every absent sub-run
                # end — ONT error spacing (~1/err_rate) is comparable to k,
                # so the default one-site-per-k walk reaches only ~28% of
                # the errors (measured, tools/polish_probe.py: 32-mer
                # identity 0.54 -> 0.78 on homopolymer-biased indel reads
                # with this schedule; the reference's GoldPolish covers
                # this with ntEdit-style indel ladders, bin/goldrush:266)
                pk = min(32, cfg.polish_k)
                sched = (((pk, 12), (20, 16), (16, 10), (pk, 8))
                         if pk > 20 else ((pk, 14), (16, 10), (pk, 6)))
                pp = polish.PolishParams(k=pk, schedule=sched,
                                         site_spacing=2)
                if streaming:
                    out, edits = polish.run_polish_streaming(
                        contigs, reads_file, pp, mapper_k=mk, mapper_w=mw)
                else:
                    out, edits = polish.run_polish(contigs, reads, pp,
                                                   mapper_k=mk, mapper_w=mw)
            with _atomic_stage(files["polished"]) as tmp:
                fastq.write_fasta(tmp, out)
            _log(f"[goldrush-jax] polish edits: {edits}")
        stage_time("polish", do_polish, files["polished"])
    if stop <= order.index("polished"):
        return {"polished": files["polished"]}

    # --- stage 4: tigmint-long equivalent ---------------------------------
    if not os.path.exists(files["tigmint"]):
        def do_tigmint():
            contigs = _read_fasta(files["polished"])
            reads = [(r.id, r.seq, r.qual)
                     for r in fastq.read_records(reads_file)]
            tp = tigmint.TigmintParams(span=cfg.span, dist=cfg.dist,
                                       cut=cfg.cut)
            out = tigmint.run_tigmint(contigs, reads, tp)
            with _atomic_stage(files["tigmint"]) as tmp:
                fastq.write_fasta(tmp, out)
        stage_time("tigmint", do_tigmint, files["tigmint"])
    if stop <= order.index("tigmint"):
        return {"tigmint": files["tigmint"]}

    # --- stage 5: ntLink rounds + gap fill --------------------------------
    gaps_file = files["ntlink"] + ".gaps.json"
    if not os.path.exists(files["ntlink"]):
        def do_ntlink():
            contigs = _read_fasta(files["tigmint"])
            reads = _load_reads(reads_file)
            np_ = ntlink.NtLinkParams(k=cfg.k_ntLink, w=cfg.w_ntLink,
                                      z=cfg.z, a=1, rounds=cfg.rounds,
                                      soft_mask=cfg.soft_mask)
            scaffolds = ntlink.run_ntlink(contigs, reads, np_)
            with _atomic_stage(files["ntlink"]) as tmp:
                fastq.write_fasta(tmp, [(s.name, s.seq) for s in scaffolds])
            with open(gaps_file, "w") as f:
                json.dump({s.name: s.filled for s in scaffolds}, f)
        stage_time("ntLink", do_ntlink, files["ntlink"])
    if stop <= order.index("ntlink"):
        return {"ntlink": files["ntlink"]}

    # --- stage 6: targeted polish (GoldPolish-Target equivalent) ----------
    if not os.path.exists(files["final"]):
        def do_target():
            entries = _read_fasta(files["ntlink"])
            gaps = {}
            if os.path.exists(gaps_file):
                gaps = json.load(open(gaps_file))
            scaffolds = [ntlink.Scaffold(name=n, seq=s,
                                         filled=[tuple(x) for x in
                                                 gaps.get(n, [])])
                         for n, s in entries]
            reads = _load_reads(reads_file)
            tp = targeted.TargetParams(flank=cfg.target_flank_length)
            out, edits = targeted.polish_targets(
                scaffolds, reads, tp,
                mapper_k=cfg.target_k_ntlink,
                mapper_w=cfg.target_w_ntlink)
            with _atomic_stage(files["final"]) as tmp:
                fastq.write_fasta(tmp, out)
            _log(f"[goldrush-jax] targeted polish edits: {edits}")
        stage_time("targeted polish", do_target, files["final"])

    lengths = [len(s) for _, s in _read_fasta(files["final"])]
    st = assembly_stats(lengths)
    _log(f"[goldrush-jax] final assembly: {st} "
         f"({time.time() - t_start:.1f}s total)")
    return {"final": files["final"], "stats": st}
