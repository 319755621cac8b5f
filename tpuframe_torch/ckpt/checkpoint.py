"""Checkpoints on the JAX package's on-disk contract (counterpart of
``tpuframe/ckpt/checkpoint.py``), so that either package restores what the
other wrote.

Layout of one checkpoint::

    <dir>/step_00000100/
        manifest.json           # leaf order, per-leaf shape/dtype/spec and
                                # shard table, CRC-32C per file, the world
        <leaf>.shard_<i>.npy    # the leaf's bytes (np.save format)
        crc_<rank>.json         # each rank's CRCs, its last write
        COMMIT                  # written last; a checkpoint without it is torn

A tree is nested dicts whose leaves are tensors (any device), numpy arrays
or Python numbers; a leaf's name is its key path joined by ``/`` (dict keys
in sorted order, as ``jax.tree_util`` flattens them) and its file name the
same with ``.`` for ``/``.  The port's state is replicated, so each leaf is
one shard, written by rank 0.  A bf16 tensor is written in the JAX
package's encoding (an ``np.save`` void record of 2 bytes, manifest dtype
``"bfloat16"``) through an int16 view, so that no numpy bfloat16 type is
needed.  :func:`restore` returns CPU tensors.

Async saves (``CheckpointManager(async_write=True)``): ``save`` takes the
snapshot and returns; serialisation, CRC, file writes and ``COMMIT`` run on
one worker thread.  The port's optimizer updates tensors in place, so the
snapshot must be a copy of step N before step N+1 writes them: on the card
each tensor is copied into pinned host memory on a side stream that waits
for the step, and the compute stream waits for the side stream before any
later kernel (see :func:`_snapshot`); on the CPU it is a clone.
"""

from __future__ import annotations

import io
import json
import re
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from tpuframe_torch import native
from tpuframe_torch.data import gcs
from tpuframe_torch.obs import events
from tpuframe_torch.parallel import collectives
from tpuframe_torch.resilience import faults

Tree = Any

_STEP_RE = re.compile(r"^step_(\d{8})$")
_MANIFEST = "manifest.json"
_COMMIT = "COMMIT"
_BF16 = "bfloat16"


def _crc32(data: bytes, algo: str = "crc32c") -> int:
    if algo == "crc32":     # honoured if a manifest records zlib's crc32
        return zlib.crc32(data)
    if algo != "crc32c":
        raise ValueError(f"unknown checkpoint checksum algorithm {algo!r}")
    return native.crc32c(data)


def _rank() -> int:
    return collectives.world()[1]


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(leaf name, leaf)]`` in ``jax.tree_util``'s order: dict keys
    sorted, names joined by ``/``."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(pairs) -> dict:
    out: dict = {}
    for name, leaf in pairs:
        node = out
        *parents, last = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _sanitize(name: str) -> str:
    return name.replace("/", ".")


def _dtype_str(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> list[int]:
    return list(leaf.shape) if hasattr(leaf, "shape") else []


def _snapshot(leaves: list, stream) -> tuple[list, Any]:
    """Host copies of ``leaves`` that later in-place updates cannot reach,
    and the event after which the copies from the card are complete (None
    when no leaf is on the card).

    The copies run on ``stream``, which first waits for the work queued
    so far (step N); the current stream then waits for ``stream``, so no
    kernel queued after this returns (step N+1's in-place updates) runs
    before the copies are done.  Nothing here waits on the host."""
    out, on_card = [], False
    main = torch.cuda.current_stream() if stream is not None else None
    if stream is not None:
        stream.wait_stream(main)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                with torch.cuda.stream(stream):
                    buf.copy_(t, non_blocking=True)
                on_card = True
                out.append(buf)
            else:
                out.append(t.clone())
        else:
            out.append(np.array(leaf, copy=True))
    if not on_card:
        return out, None
    done = stream.record_event()
    main.wait_stream(stream)
    return out, done


def _to_numpy(leaf) -> np.ndarray:
    """A host leaf as the numpy array written to disk (bf16 as its int16
    bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _npy_bytes(arr: np.ndarray, dtype: str) -> bytes:
    """``np.save`` bytes of ``arr``; bf16 with the header numpy writes for
    the JAX package's bfloat16 arrays (a 2-byte void record, ``<V2``), so
    both packages write the same bytes."""
    buf = io.BytesIO()
    if dtype == _BF16:
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<V2", "fortran_order": False,
                  "shape": arr.shape})
        buf.write(arr.tobytes())
    else:
        np.save(buf, arr)
    return buf.getvalue()


def _prepare_save(directory: str, step: int, tree: Tree, *, sink=None):
    """The synchronous part of a save: the step's directory with stale
    artifacts of an earlier save of this step removed (this rank's
    sidecar, ``COMMIT``, the manifest), and the manifest.

    ``sink`` given (sync save): each leaf rank 0 writes goes to
    ``sink([(file name, leaf, dtype)])`` at once, one leaf at a time.
    ``sink=None`` (async save): the leaves are snapshotted
    (:func:`_snapshot`) and returned with the event to wait for before
    reading them: ``(path, manifest, (owned files, event))``."""
    path = gcs.join(directory, f"step_{step:08d}")
    gcs.makedirs(path)
    rank = _rank()
    for stale in (gcs.join(path, f"crc_{rank}.json"),
                  gcs.join(path, _COMMIT), gcs.join(path, _MANIFEST)):
        if gcs.exists(stale):
            gcs.delete(stale)
    pairs = _flatten(tree)
    processes = collectives.world()[0]
    manifest: dict = {
        "version": 1,
        "step": step,
        "leaf_order": [name for name, _ in pairs],
        "leaves": {},
        "crc": {},
        "crc_algo": "crc32c",
        # one card a rank
        "world": {"processes": processes, "devices": processes},
    }
    owned = []
    for name, leaf in pairs:
        fname = f"{_sanitize(name)}.shard_0.npy"
        dtype = _dtype_str(leaf)
        manifest["leaves"][name] = {
            "shape": _shape(leaf), "dtype": dtype, "spec": [],
            "shards": [{"id": 0, "index": None, "file": fname}]}
        if rank != 0:
            continue
        if sink is not None:
            sink([(fname, leaf, dtype)])
        else:
            owned.append((fname, leaf, dtype))
    if sink is not None:
        return path, manifest, None
    stream = (torch.cuda.Stream() if any(
        isinstance(leaf, torch.Tensor) and leaf.is_cuda
        for _, leaf, _ in owned) else None)
    copies, done = _snapshot([leaf for _, leaf, _ in owned], stream)
    return path, manifest, ([(f, c, d) for (f, _, d), c in
                             zip(owned, copies)], done)


def _write_files(path: str, owned) -> dict:
    """Serialise and write shard files; returns ``{file name: crc}``."""
    crc_local: dict[str, int] = {}
    for fname, leaf, dtype in owned:
        raw = _npy_bytes(_to_numpy(leaf), dtype)
        # The ckpt_shard seam mangles the bytes written while the CRC
        # covers the clean bytes: storage-side corruption, which restore
        # must catch.
        gcs.write_bytes(gcs.join(path, fname), faults.mangle("ckpt_shard",
                                                             raw))
        crc_local[fname] = _crc32(raw)
    return crc_local


def _write_sidecar(path: str, crc_local: dict) -> None:
    """This rank's CRC sidecar, its last write: its presence (with a
    fresh mtime) means the rank's files are written."""
    gcs.write_bytes(gcs.join(path, f"crc_{_rank()}.json"),
                    json.dumps(crc_local).encode())


def _write_owned(path: str, owned, done) -> dict:
    """The async worker's whole write: wait for the snapshot's copies,
    then files and sidecar."""
    if done is not None:
        done.synchronize()
    crc_local = _write_files(path, owned)
    # The worst moment for an upload to die: the bytes are on storage and
    # nothing acknowledges them (no sidecar, so no COMMIT: torn).
    faults.fire("crash_during_upload")
    _write_sidecar(path, crc_local)
    return crc_local


def _finalize(path: str, manifest: dict, *, poll: bool,
              min_mtime: float = 0.0, timeout_s: float = 600.0) -> None:
    """Rank 0 merges every rank's CRC sidecar and writes the manifest,
    then ``COMMIT``.  ``poll=False``: the caller synchronised (the sync
    save's barrier).  ``poll=True``: wait for fresh sidecars instead, as
    the async worker must (only the training loop runs collectives).  On
    timeout the checkpoint stays torn."""
    if _rank() != 0:
        return
    deadline = time.time() + timeout_s
    crc: dict[str, int] = {}
    for i in range(collectives.world()[0]):
        sidecar = gcs.join(path, f"crc_{i}.json")
        while poll and not (gcs.exists(sidecar)
                            and gcs.mtime(sidecar) >= min_mtime):
            if time.time() > deadline:
                print(f"[ckpt] finalize timeout: rank {i} sidecar missing "
                      f"or stale; leaving {path} uncommitted", flush=True)
                return
            time.sleep(0.2)
        crc.update(json.loads(gcs.read_bytes(sidecar)))
    manifest["crc"] = crc
    gcs.write_bytes(gcs.join(path, _MANIFEST),
                    json.dumps(manifest, indent=1).encode())
    gcs.write_bytes(gcs.join(path, _COMMIT), b"ok")


def _barrier() -> None:
    """Every rank's files are written before rank 0 commits."""
    if collectives.world()[0] > 1:
        import torch.distributed as dist

        dist.barrier()


def save(directory: str, step: int, tree: Tree) -> str:
    """Write one checkpoint synchronously and return its path.  Every rank
    calls it.  Streams leaf by leaf: the extra host memory is one leaf."""
    crc_local: dict[str, int] = {}
    path = gcs.join(directory, f"step_{step:08d}")

    def sink(owned):
        crc_local.update(_write_files(path, owned))

    _, manifest, _ = _prepare_save(directory, step, tree, sink=sink)
    _write_sidecar(path, crc_local)
    _barrier()
    _finalize(path, manifest, poll=False)
    return path


def _load_shard(path: str, fname: str, crcs: dict, verify_crc: bool,
                algo: str) -> np.ndarray:
    raw = gcs.read_bytes(gcs.join(path, fname))
    if verify_crc and fname in crcs and _crc32(raw, algo) != crcs[fname]:
        raise IOError(f"CRC mismatch in checkpoint shard {fname} — corrupt "
                      f"file")
    return np.load(io.BytesIO(raw), allow_pickle=False)


def _assemble(path: str, entry: dict, crcs: dict, verify_crc: bool,
              algo: str) -> np.ndarray:
    """A leaf from its shard files (a JAX checkpoint of a sharded leaf
    has several, each with its index)."""
    shape = tuple(entry["shape"])
    shards = entry["shards"] or []
    if not shards:
        raise FileNotFoundError(f"manifest entry has no shard files: "
                                f"{entry}")
    first = _load_shard(path, shards[0]["file"], crcs, verify_crc, algo)
    if shards[0]["index"] is None or first.shape == shape:
        return first
    out = np.empty(shape, first.dtype)
    for sh in shards:
        data = _load_shard(path, sh["file"], crcs, verify_crc, algo)
        out[tuple(slice(lo, hi) for lo, hi in sh["index"])] = data
    return out


def _to_torch(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded shard as a CPU tensor of the manifest's dtype (a void
    record of 2 bytes is bf16 through its int16 bits)."""
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    arr = arr.astype(np.dtype(dtype), copy=False)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = arr.copy()
    return torch.from_numpy(arr)


def restore(directory: str, step: int, *, target: Tree | None = None,
            verify_crc: bool = True) -> Tree:
    """Load the committed checkpoint of ``step`` as nested dicts of CPU
    tensors.  With ``target`` (a tree of the same structure) the leaf
    names must match (else ValueError), each tensor's shape must match its
    target's, and a leaf whose target is a Python number comes back as
    one."""
    path = gcs.join(directory, f"step_{step:08d}")
    if not gcs.exists(gcs.join(path, _COMMIT)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads(gcs.read_bytes(gcs.join(path, _MANIFEST)))
    names = manifest["leaf_order"]
    algo = manifest.get("crc_algo", "crc32c")

    def load(name: str) -> torch.Tensor:
        entry = manifest["leaves"][name]
        arr = _assemble(path, entry, manifest["crc"], verify_crc, algo)
        return _to_torch(arr, entry["dtype"])

    if target is None:
        return _unflatten((name, load(name)) for name in names)
    pairs = _flatten(target)
    if {n for n, _ in pairs} != set(names):
        missing = {n for n, _ in pairs} - set(names)
        extra = set(names) - {n for n, _ in pairs}
        raise ValueError(f"checkpoint/target structure mismatch; "
                         f"missing={sorted(missing)} extra={sorted(extra)}")
    out = []
    for name, tgt in pairs:
        want = tuple(_shape(tgt))
        got = tuple(manifest["leaves"][name]["shape"])
        if got != want:
            raise ValueError(f"checkpoint leaf {name!r} shape {got} does "
                             f"not match target shape {want}")
        t = load(name)
        if isinstance(tgt, (bool, int, float)):
            t = type(tgt)(t.item())
        out.append((name, t))
    return _unflatten(out)


def _committed_steps(directory: str) -> list[int]:
    """Committed checkpoint steps, ascending (a ``.corrupt`` directory
    does not match)."""
    steps = []
    for name in gcs.listdir(directory):
        m = _STEP_RE.match(name)
        if m and gcs.exists(gcs.join(directory, name, _COMMIT)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def committed_world(directory: str) -> dict | None:
    """``{"step", "processes", "devices"}`` of the newest committed
    checkpoint, or None.  A read-only peek: it never quarantines."""
    try:
        steps = _committed_steps(directory)
        if not steps:
            return None
        manifest = json.loads(gcs.read_bytes(
            gcs.join(directory, f"step_{steps[-1]:08d}", _MANIFEST)))
        world = manifest.get("world")
        if isinstance(world, dict) and "devices" in world:
            return {"step": steps[-1], **world}
    except (OSError, EOFError, KeyError, ValueError):
        return None
    return None


def in_flight_step(directory: str) -> int | None:
    """The highest ``step_N`` directory without ``COMMIT``: an async save
    still writing, or killed while it wrote."""
    try:
        names = gcs.listdir(directory)
    except OSError:
        return None
    steps = [int(m.group(1)) for m in map(_STEP_RE.match, names)
             if m and not gcs.exists(gcs.join(directory, m.group(0),
                                              _COMMIT))]
    return max(steps) if steps else None


def quarantine_step(directory: str, step: int) -> str:
    """Rename ``step_N`` to ``step_N.corrupt``: resume skips it and the
    evidence stays.  Rank 0 renames."""
    src = gcs.join(directory, f"step_{step:08d}")
    dst = src + ".corrupt"
    if _rank() == 0:
        gcs.rename_tree(src, dst)
    return dst


class CheckpointManager:
    """Periodic saves, retention, the best checkpoint and resume from the
    newest readable one.

    ``async_write=True``: :meth:`save` takes the snapshot and returns;
    files and ``COMMIT`` land on one worker thread, so saves commit in
    order and the training loop never waits on storage.  Call
    :meth:`wait_pending` before reading the newest checkpoint back or
    exiting, or :meth:`flush` on a deadline."""

    def __init__(self, directory: str, *, every_steps: int = 1000,
                 keep: int = 3, async_write: bool = False):
        self.directory = directory
        self.every_steps = every_steps
        self.keep = keep
        self.async_write = async_write
        # (worker, step, path) per async save in flight.  _mutex guards
        # _pending, _errors and _last_path; no join runs under it (the
        # worker takes it to report an error).
        self._mutex = threading.Lock()
        self._pending: list[tuple[threading.Thread, int, str]] = []
        self._errors: list[str] = []
        self._last_path: str | None = None
        gcs.makedirs(directory)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every_steps == 0

    def save(self, step: int, tree: Tree) -> str:
        if not self.async_write:
            t0 = time.perf_counter()
            path = save(self.directory, step, tree)
            self._gc()
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            events.emit("ckpt_save", step=step, ms=ms, block_ms=ms,
                        async_write=False)
            return path
        prep_t0 = time.time()
        path, manifest, (owned, done) = _prepare_save(self.directory, step,
                                                      tree)
        # Backpressure: each queued save holds a host copy of the state;
        # at most one writing and one queued.
        while True:
            with self._mutex:
                self._pending = [p for p in self._pending
                                 if p[0].is_alive()]
                oldest = (self._pending[0][0]
                          if len(self._pending) >= 2 else None)
                prev = self._pending[-1][0] if self._pending else None
            if oldest is None:
                break
            oldest.join()
        block_ms = round((time.time() - prep_t0) * 1e3, 3)

        def work():
            try:
                if prev is not None:
                    prev.join()         # saves commit in order
                w0 = time.time()
                _write_owned(path, owned, done)
                _finalize(path, manifest, poll=True,
                          min_mtime=prep_t0 - 60.0)
                self._gc()
                now = time.time()
                events.emit("ckpt_save", step=step,
                            ms=round((now - prep_t0) * 1e3, 3),
                            block_ms=block_ms,
                            write_ms=round((now - w0) * 1e3, 3),
                            async_write=True)
            except Exception as e:  # noqa: BLE001 — raised by wait_pending
                with self._mutex:
                    self._errors.append(f"save step {step}: "
                                        f"{type(e).__name__}: {e}")

        t = threading.Thread(target=work, name=f"ckpt-save-{step}",
                             daemon=True)
        with self._mutex:
            self._pending.append((t, step, path))
            self._last_path = path
        t.start()
        # SIGTERM while the upload is in flight: the window flush() is for
        faults.fire("sigterm_pending_upload")
        return path

    def save_best(self, step: int, tree: Tree, metric: float, *,
                  mode: str = "min") -> bool:
        """Keep the single best-by-metric checkpoint under ``best/``;
        True when ``metric`` beat the stored record and the state was
        saved (synchronously).  Every rank calls it with the same
        metric."""
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        best_dir = gcs.join(self.directory, "best")
        record_path = gcs.join(best_dir, "metric.json")
        prev = None
        if gcs.exists(record_path):
            record = json.loads(gcs.read_bytes(record_path))
            if record.get("mode", mode) != mode:
                raise ValueError(
                    f"save_best mode {mode!r} contradicts the stored best "
                    f"record's mode {record['mode']!r} in {best_dir}")
            prev = record["metric"]
        if not (prev is None
                or (metric < prev if mode == "min" else metric > prev)):
            return False
        # The new best first (COMMIT-atomic), then the record, then the
        # old directory: a preemption between them never loses the best.
        save(best_dir, step, tree)
        if _rank() == 0:
            gcs.write_bytes(record_path, json.dumps(
                {"metric": float(metric), "step": step,
                 "mode": mode}).encode())
            new_name = f"step_{step:08d}"
            for m in map(_STEP_RE.match, gcs.listdir(best_dir)):
                if m and m.group(0) != new_name:
                    gcs.delete_tree(gcs.join(best_dir, m.group(0)))
        return True

    def restore_best(self, *, target: Tree | None = None):
        """``(step, tree)`` of the best checkpoint, or None; the step comes
        from the record."""
        best_dir = gcs.join(self.directory, "best")
        record_path = gcs.join(best_dir, "metric.json")
        step = None
        if gcs.exists(record_path):
            step = int(json.loads(gcs.read_bytes(record_path))["step"])
            if not gcs.exists(gcs.join(best_dir, f"step_{step:08d}",
                                       _COMMIT)):
                step = None
        if step is None:
            step = latest_step(best_dir)
        if step is None:
            return None
        return step, restore(best_dir, step, target=target)

    def wait_pending(self, *, commit_timeout_s: float = 600.0) -> None:
        """Block until every async save has committed; raises if one
        failed.  A rank other than 0 also waits for rank 0's COMMIT."""
        with self._mutex:
            pending = list(self._pending)
        for t, _, _ in pending:
            t.join()
        with self._mutex:
            self._pending = [p for p in self._pending if p not in pending]
            errs = "; ".join(self._errors)
            self._errors = []
            last = self._last_path
        if errs:
            raise RuntimeError(f"async checkpoint save(s) failed: {errs}")
        if last is None or _rank() == 0:
            return
        deadline = time.time() + commit_timeout_s
        while not gcs.exists(gcs.join(last, _COMMIT)):
            if time.time() > deadline:
                print(f"[ckpt] wait_pending: no COMMIT at {last} after "
                      f"{commit_timeout_s}s", flush=True)
                return
            time.sleep(0.2)

    def flush(self, deadline_s: float = 60.0) -> bool:
        """Drain the async saves within ``deadline_s`` (the exit gate of a
        preemption): each pending save commits (True) or its step is
        quarantined (False), so nothing uncommitted is left to mistake for
        durable.  Worker errors are printed, not raised."""
        deadline = time.time() + deadline_s
        with self._mutex:
            pending = list(self._pending)
        for t, _, _ in pending:
            t.join(max(0.0, deadline - time.time()))
        with self._mutex:
            self._pending = [p for p in self._pending if p not in pending]
            errs = "; ".join(self._errors)
            self._errors = []
        if errs:
            print(f"[ckpt] flush: async save error(s): {errs}", flush=True)
        all_committed = True
        for t, step, path in pending:
            committed = gcs.exists(gcs.join(path, _COMMIT))
            # ranks other than 0: rank 0 commits after this rank's worker
            while (not committed and not t.is_alive() and _rank() != 0
                   and time.time() <= deadline):
                time.sleep(0.1)
                committed = gcs.exists(gcs.join(path, _COMMIT))
            if committed:
                continue
            all_committed = False
            quarantine_step(self.directory, step)
            print(f"[ckpt] flush: step {step} uncommitted at deadline "
                  f"({deadline_s:.1f}s) — quarantined, resume will use "
                  f"the previous committed step", flush=True)
        return all_committed

    def maybe_save(self, step: int, tree: Tree) -> str | None:
        return self.save(step, tree) if self.should_save(step) else None

    def restore_latest(self, *, target: Tree | None = None):
        """``(step, tree)`` of the newest readable committed checkpoint,
        or None.  A committed checkpoint that cannot be read (CRC
        mismatch, garbled manifest, missing shard) is quarantined and the
        walk goes back to the previous step; a structure mismatch
        (ValueError) raises, being a configuration error."""
        tried: set[int] = set()
        while True:
            steps = [s for s in _committed_steps(self.directory)
                     if s not in tried]
            if not steps:
                return None
            step = steps[-1]
            tried.add(step)
            try:
                t0 = time.perf_counter()
                out = step, restore(self.directory, step, target=target)
                events.emit("ckpt_restore", step=step, ms=round(
                    (time.perf_counter() - t0) * 1e3, 3))
                return out
            except (OSError, EOFError, KeyError,
                    json.JSONDecodeError) as e:
                quarantined = quarantine_step(self.directory, step)
                print(f"[ckpt] WARNING: checkpoint step {step} is "
                      f"unreadable ({type(e).__name__}: {e}) — quarantined "
                      f"to {quarantined}; walking back to the previous "
                      f"committed step", flush=True)

    def _gc(self) -> None:
        """Keep the newest ``keep`` committed checkpoints (an uncommitted
        directory may be a save in flight and is never deleted)."""
        if _rank() != 0 or self.keep <= 0:
            return
        for old in _committed_steps(self.directory)[:-self.keep]:
            gcs.delete_tree(gcs.join(self.directory, f"step_{old:08d}"))
