"""Run management: output dirs, seeding, logging, config dumps and the
code snapshot (a copy of ``youtube_vln_tpu/utils/misc.py``).

Mirrors reference ``utils/misc.py`` behaviors: incrementing run directories
``{output_dir}/{save_name}{sep}{N}_{timestamp}_{note}`` (:60-73), seeding
(:37-45), stdout+file logging (:22-33), the code snapshot (exp_saver,
:96-113), and the config.txt dump (pretrain.py:57-64) with the git
revision.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import random
import re
import subprocess
import sys
import time
from glob import glob
from pathlib import Path
from typing import Optional

import numpy as np


def get_logger(name: str, file: str = "") -> logging.Logger:
    logging.basicConfig(format="%(message)s", level=logging.INFO,
                        stream=sys.stdout)
    logger = logging.getLogger(name)
    if file:
        # loggers are process-global: a second get_logger(name, file) call
        # (engine re-init, train+eval phases) must not attach a second
        # FileHandler or every record duplicates in the file (the
        # reference's misc.py:28-33 does duplicate; deliberate fix)
        # logging sets baseFilename via os.path.abspath (symlinks NOT
        # resolved) — resolve both sides so a path through a symlinked
        # directory still matches the existing handler
        target = str(Path(file).resolve())
        if not any(isinstance(h, logging.FileHandler)
                   and str(Path(h.baseFilename).resolve()) == target
                   for h in logger.handlers):
            logger.addHandler(logging.FileHandler(file))
    return logger


class NoneLogger:
    def info(self, *a, **k):
        pass

    def warning(self, *a, **k):
        pass


def set_seed(seed: int, process_index: int = 0) -> None:
    """Base seed + process index, like the reference's seed+local_rank
    (misc.py:37-45)."""
    if seed:
        random.seed(seed + process_index)
        np.random.seed(seed + process_index)


def increment_path(path, sep="", note="") -> Path:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    dirs = glob(f"{path}{sep}*")
    # match on path.name, not path.stem: a dotted save_name ('model.v2')
    # would otherwise never match its own prior runs and every run would
    # get n=1 (the reference's misc.py:67 has the stem bug; deliberate fix)
    matches = [re.search(rf"{re.escape(path.name)}{re.escape(sep)}(\d+)", d)
               for d in dirs]
    nums = [int(m.groups()[0]) for m in matches if m]
    n = max(nums) + 1 if nums else 1
    stamp = time.strftime("%Y-%m-%d_%H:%M:%S", time.localtime())
    return Path(f"{path}{sep}{n}_{stamp}_{note}_")


def get_output_dir(args, sep="/train") -> Path:
    return increment_path(Path(args.output_dir) / args.save_name, sep=sep,
                          note=args.note).resolve()


def git_revision() -> Optional[str]:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL,
            text=True).strip()
    except Exception:
        return None


def save_code_snapshot(save_folder: Path,
                       ignore=("data", "result", "results", ".git",
                               "__pycache__", ".vscode", "youtube_data")
                       ) -> Optional[Path]:
    """Zip the source tree next to the run plus a rerun script (reference
    exp_saver, misc.py:96-113)."""
    import zipfile
    from shlex import quote

    out_dir = Path(save_folder) / "sh_n_codes"
    out_dir.mkdir(parents=True, exist_ok=True)
    zip_path = out_dir / "code.zip"
    root = Path.cwd()
    try:
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            # os.walk with in-place dirnames pruning: rglob would traverse
            # (and stat) the entire ignored trees first, on a data host
            # the feature stores under data/
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = [d for d in dirnames if d not in ignore]
                for name in filenames:
                    if name.endswith(".py"):
                        path = Path(dirpath) / name
                        zf.write(path, path.relative_to(root))
        with open(out_dir / "rerun.sh", "w") as f:
            f.write(f"cd {quote(str(root))}\n")
            f.write(sys.executable + " "
                    + " ".join(quote(a) for a in sys.argv) + "\n")
        return zip_path
    except OSError:
        return None


def dump_config(save_folder: Path, args, model_config=None) -> None:
    """config.txt dump (reference pretrain.py:57-64) + git revision."""
    save_folder.mkdir(parents=True, exist_ok=True)
    with open(save_folder / "config.txt", "w") as fid:
        print("args:\n{", file=fid)
        src = (dataclasses.asdict(args) if dataclasses.is_dataclass(args)
               else vars(args))
        for name, value in src.items():
            print(f"  '{name}': {value}", file=fid)
        print("}\n", file=fid)
        if model_config is not None:
            print("config:", file=fid)
            print(model_config, file=fid)
        rev = git_revision()
        if rev:
            print(f"git: {rev}", file=fid)
        print(f"argv: {' '.join(sys.argv)}", file=fid)
