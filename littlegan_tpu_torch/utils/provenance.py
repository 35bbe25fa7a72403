"""Experiment hygiene / run provenance, the port's copy of littlegan_tpu/utils/provenance.py.

Capability parity with reference main.py:27-29 and eager_trainer.py:231-245:
- refuse to train on a dirty git tree unless ``--debug``,
- create the full result directory tree,
- dump the merged config to ``result/<exp>/config.json``,
- snapshot the code (``git archive`` -> ``code.tar``).

Uses the ``git`` CLI via subprocess instead of GitPython (not a baked-in dep).
"""

from __future__ import annotations

import os
import subprocess
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from littlegan_tpu_torch.config import Config

# reference eager_trainer.py:233-236 creates exactly this tree
RESULT_SUBDIRS = (
    ".",
    "train/gen",
    "train/adj",
    "test/adj",
    "test/gen",
    "test/disc",
    "checkpoint",
    "log",
    "sample",
    "evaluate/gen",
    "evaluate/adj",
    "evaluate/disc",
    "model",
)


def _default_repo_root() -> str:
    """The repository CONTAINING THIS CODE — not the process cwd. Running
    ``cd /tmp && python -m littlegan_tpu_torch train …`` must still check the
    framework checkout's tree, and a cwd outside any repo must not read as
    'clean'."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def git_is_dirty(repo_root: Optional[str] = None) -> bool:
    """True if the working tree has uncommitted changes (reference: main.py:27-29)."""
    try:
        out = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=repo_root or _default_repo_root(),
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return False  # no git -> treat as clean (reference would crash instead)
    if out.returncode != 0:
        # not a git checkout (pip-installed package): nothing to check.
        # An actual git FAILURE (dubious ownership etc.) prints its stderr
        # so 'clean' is never silently reported on a broken git.
        if out.stderr.strip():
            print(f"git status failed ({out.stderr.strip()[:120]}); skipping dirty check")
        return False
    return bool(out.stdout.strip())


def ensure_clean_tree(cfg: "Config", repo_root: Optional[str] = None) -> None:
    if cfg.mode == "train" and not cfg.debug and git_is_dirty(repo_root):
        raise EnvironmentError(
            "Git repo is dirty! Commit before training or pass --debug "
            "(reference semantics, main.py:27-29)."
        )


def init_result_dirs(cfg: "Config") -> str:
    """Create the result tree (reference: eager_trainer.py:231-239)."""
    os.makedirs(cfg.test_data_dir, exist_ok=True)
    for sub in RESULT_SUBDIRS:
        os.makedirs(os.path.join(cfg.result_dir, sub), exist_ok=True)
    return cfg.result_dir


def snapshot_run(cfg: "Config", repo_root: Optional[str] = None) -> None:
    """Dump config.json + code.tar into the result dir (reference: eager_trainer.py:240-245)."""
    init_result_dirs(cfg)
    cfg.dump(os.path.join(cfg.result_dir, "config.json"))
    if not cfg.debug:
        tar_path = os.path.join(cfg.result_dir, "code.tar")
        try:
            with open(tar_path, "wb") as f:
                subprocess.run(
                    ["git", "archive", "HEAD"],
                    cwd=repo_root or _default_repo_root(),
                    stdout=f,
                    timeout=60,
                    check=True,
                )
        except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
            if os.path.exists(tar_path):
                os.remove(tar_path)
