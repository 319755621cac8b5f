"""Storage paths (counterpart of ``tpuframe/data/gcs.py``), the local half.

One path API for the checkpoints: every operation runs under a
:class:`~tpuframe_torch.resilience.policy.RetryPolicy` and passes through
its fault seam (``gcs_read``, ``gcs_write``, ``gcs_list``, ``gcs_stat``,
``gcs_delete``, ``slow_gcs``; see ``resilience/faults.py``), so that
recovery from flaky storage is testable with a local directory.  A
``gs://`` path raises: the bucket client waits for ROADMAP.md queue 1,
item 4.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

from tpuframe_torch.resilience import faults
from tpuframe_torch.resilience.policy import RetryPolicy

_POLICY = RetryPolicy(
    max_attempts=int(os.environ.get("TPUFRAME_IO_RETRIES", "5")),
    base_delay_s=float(os.environ.get("TPUFRAME_IO_RETRY_BASE_S", "0.05")),
    max_delay_s=float(os.environ.get("TPUFRAME_IO_RETRY_MAX_S", "5.0")),
    deadline_s=float(os.environ.get("TPUFRAME_IO_DEADLINE_S", "120")),
)


def is_gcs_path(path: str) -> bool:
    return str(path).startswith("gs://")


def _local(path: str) -> str:
    if is_gcs_path(path):
        raise NotImplementedError(
            f"{path}: gs:// storage is not ported yet (ROADMAP.md queue 1, "
            f"item 4); use a local directory")
    return path


def read_bytes(path: str) -> bytes:
    return _POLICY.call(_read_bytes_once, _local(path), op="gcs_read")


def _read_bytes_once(path: str) -> bytes:
    faults.fire("gcs_read")
    return Path(path).read_bytes()


def write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` atomically: a temporary file, then a rename, so a
    reader never sees a torn file."""
    _local(path)
    # Degraded-storage seam, outside the retry wrapper: a slow but healthy
    # backend must not use up attempts.
    faults.fire("slow_gcs")
    _POLICY.call(_write_bytes_once, path, data, op="gcs_write")


def _write_bytes_once(path: str, data: bytes) -> None:
    faults.fire("gcs_write")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, p)


def exists(path: str) -> bool:
    return _POLICY.call(_exists_once, _local(path), op="gcs_stat")


def _exists_once(path: str) -> bool:
    faults.fire("gcs_stat")
    return Path(path).exists()


def listdir(path: str) -> list[str]:
    """Immediate children (names, not paths), sorted; [] if absent."""
    return _POLICY.call(_listdir_once, _local(path), op="gcs_list")


def _listdir_once(path: str) -> list[str]:
    faults.fire("gcs_list")
    return sorted(os.listdir(path)) if os.path.exists(path) else []


def makedirs(path: str) -> None:
    Path(_local(path)).mkdir(parents=True, exist_ok=True)


def mtime(path: str) -> float:
    """Last-modified time (unix seconds); 0.0 if absent."""
    return _POLICY.call(_mtime_once, _local(path), op="gcs_stat")


def _mtime_once(path: str) -> float:
    faults.fire("gcs_stat")
    try:
        return os.path.getmtime(path)
    except FileNotFoundError:
        return 0.0


def delete(path: str) -> None:
    """Delete one file (no-op if absent)."""
    _POLICY.call(_delete_once, _local(path), op="gcs_delete")


def _delete_once(path: str) -> None:
    faults.fire("gcs_delete")
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def delete_tree(path: str) -> None:
    _POLICY.call(_delete_tree_once, _local(path), op="gcs_delete")


def _delete_tree_once(path: str) -> None:
    faults.fire("gcs_delete")
    shutil.rmtree(path, ignore_errors=True)


def rename_tree(src: str, dst: str) -> None:
    """Rename a directory (the quarantine of a corrupt checkpoint:
    ``step_N`` → ``step_N.corrupt``); atomic on a local filesystem."""
    _local(dst)
    _POLICY.call(_rename_tree_once, _local(src), dst, op="gcs_write")


def _rename_tree_once(src: str, dst: str) -> None:
    faults.fire("gcs_write")
    os.replace(src, dst)


def join(*parts: str) -> str:
    return os.path.join(*parts)
