"""Command-line interface mirroring the reference's make-style driver.

Usage (same command/parameter names as bin/goldrush):

    python -m goldrush_jax.cli run reads=myreads G=3e9 t=48
    python -m goldrush_jax.cli goldrush-path reads=r G=1e6
    python -m goldrush_jax.cli path-tigmint-ntLink-target reads=r G=1e6
    python -m goldrush_jax.cli version | help

Commands map to pipeline depth exactly like the make targets
(bin/goldrush:220-224); parameters are make-style key=value pairs with the
reference defaults (bin/goldrush:60-97).
"""

from __future__ import annotations

import dataclasses
import os
import sys

from .config import PipelineConfig, stage_filenames

VERSION = "0.1.0 (goldrush-jax; capabilities of GoldRush v1.2.2)"

COMMANDS = {
    "run": "final",
    "run-in-dir": "final",
    "goldrush-path": "golden",
    "path-polish": "polished",
    "path-tigmint": "tigmint",
    "path-tigmint-ntLink": "ntlink",
    "path-tigmint-ntLink-target": "final",
}

_FLOATS = {"o", "r"}
_STRS = {"reads", "p", "prefix", "s", "polisher", "polisher_mapper"}
_BOOLS = {"track_time", "dev", "soft_mask"}


def parse_args(argv: list[str]) -> tuple[str, PipelineConfig, dict]:
    if not argv or argv[0] in ("help", "--help", "-h"):
        return "help", PipelineConfig(), {}
    if argv[0] in ("version", "--version"):
        return "version", PipelineConfig(), {}
    cmd = argv[0]
    if cmd not in COMMANDS:
        raise SystemExit(f"Unknown command: {cmd} (see 'help')")
    cfg = PipelineConfig()
    extra = {}
    fields = {f.name for f in dataclasses.fields(PipelineConfig)}
    for arg in argv[1:]:
        if "=" not in arg:
            raise SystemExit(f"Parameters are key=value pairs, got: {arg}")
        k, v = arg.split("=", 1)
        if k in ("frame_stride", "probe_seeds"):
            extra[k] = int(v)
            continue
        if k in ("save_mibf", "load_mibf", "trace_dir"):
            # engine-level passthrough (applied to the FIRST goldrush-path
            # stage that runs); save/load are the checkpoint analog of the
            # reference's dev-only MIBloomFilter::store
            extra[k] = v
            continue
        if k not in fields:
            raise SystemExit(f"Unknown parameter: {k}")
        if k in _STRS:
            val = v
        elif k in _BOOLS:
            val = v in ("1", "True", "true")
        elif k in _FLOATS:
            val = float(v)
        else:
            val = int(float(v))
        setattr(cfg, k, val)
    return cmd, cfg, extra


def print_help() -> None:
    print(__doc__)
    print("Commands:", ", ".join(COMMANDS))
    print("Key parameters: reads=<prefix> G=<genome size> t=<threads> "
          "k w tile b u a o x h s m M r P d span dist cut k_ntLink "
          "w_ntLink rounds z p frame_stride probe_seeds "
          "save_mibf=<npz> load_mibf=<npz> trace_dir=<dir>")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd, cfg, extra = parse_args(argv)
    if cmd == "help":
        print_help()
        return 0
    if cmd == "version":
        print(f"goldrush-jax version: {VERSION}")
        return 0
    from .pipeline import run_pipeline
    until = COMMANDS[cmd]
    workdir = "." if cmd == "run-in-dir" else cfg.prefix
    if cmd == "run":
        os.makedirs(workdir, exist_ok=True)
        # symlink reads into the working dir like bin/goldrush:210-211
        for ext in (".fq", ".fastq", ".fq.gz", ".fastq.gz"):
            src = cfg.reads + ext
            if os.path.exists(src):
                dst = os.path.join(workdir, os.path.basename(src))
                if not os.path.exists(dst):
                    os.symlink(os.path.abspath(src), dst)
                cfg = cfg.replace(reads=os.path.basename(cfg.reads))
                break
    out = run_pipeline(cfg, workdir=workdir, until=until,
                       frame_stride=extra.get("frame_stride", 1),
                       probe_seeds=extra.get("probe_seeds", 0),
                       engine_extra={k: v for k, v in extra.items()
                                     if k in ("save_mibf", "load_mibf",
                                              "trace_dir")})
    if "final" in out:
        final = os.path.join(workdir, out["final"])
        link = os.path.basename(out["final"])
        if cmd == "run" and not os.path.exists(link):
            os.symlink(final, link)
        print(f"Final assembly: {out['final']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
