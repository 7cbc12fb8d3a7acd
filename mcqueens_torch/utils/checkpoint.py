"""Periodic checkpoint/resume for long annealing runs, port of
:mod:`mcqueens.utils.checkpoint`.

The whole sampler state is a carry of per-chain tensors (heights or queens,
count table, key words, best state, stats counters), so a checkpoint is a
host-side ``npz`` dump between segments.  Restores are exact: the carry *is*
the chain and every per-step draw is a counter hash, so a resumed run equals
an uninterrupted one bit for bit.

Same file layout as the JAX package: ``<tag>.npz`` holds the carry's fields
as ``carry_<name>``, ``segments_done``, ``seg_outer``, ``fingerprint``,
``n_history_chunks`` and ``extra_<i>``; each history chunk is its own
``<tag>.<fp8>.hist<i>.npy``.  The carries are frozen dataclasses of tensors:
a ``None`` field (the ``naive`` scan's ``table``) is not saved and stays
``None``; the scan carries' ``step_base`` ((C, 2) int64 holding uint32 key
words) is saved as uint32 words, as JAX saves its keys' ``key_data``.
A run sharded over a mesh (:mod:`mcqueens_torch.dist.mesh`) saves its whole
carry, the shards gathered in shard order (the JAX package's sharded arrays
read back in global order), and restores it whole before splitting it again,
so its files equal an unsharded save of the same carry.

Each file a save writes is one ``mcq.checkpoint.write`` span
(:func:`mcqueens_torch.utils.profiling.span`, inside the caller's
``mcq.checkpoint``); :data:`SAVES` counts the saves that wrote.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import os
import tempfile
import time

import numpy as np
import torch

from mcqueens_torch.utils import profiling

# Fields holding threefry key words: int64 tensors on the device, uint32
# words on disk.
KEY_FIELDS = ("step_base",)

# Saves that wrote their files in this process (every Checkpointer).
SAVES = 0


def spec_fingerprint(spec, seeds) -> str:
    """Digest of everything that defines a run's trajectory.

    Two runs with the same carry *shapes* but different dynamics (beta range,
    schedule kind, n_steps, kernel, seeds, ...) must not resume from each
    other's checkpoints; shape checks alone cannot tell them apart.  The
    spec and its schedule are plain frozen dataclasses, so their ``repr`` is
    the same in every process.
    """
    h = hashlib.sha256()
    h.update(repr(spec).encode())
    h.update(np.ascontiguousarray(np.asarray(seeds)).tobytes())
    return h.hexdigest()[:32]


def extend_fingerprint(fp: str, *arrays) -> str:
    """Fold extra run-defining arrays (ladder, swap seed, ...) into a digest."""
    h = hashlib.sha256(fp.encode())
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:32]


def _fields(carry) -> dict:
    return {f.name: getattr(carry, f.name)
            for f in dataclasses.fields(carry)}


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if name in KEY_FIELDS else a


def _stored_dtype(name: str, t: torch.Tensor) -> np.dtype:
    return (np.dtype(np.uint32) if name in KEY_FIELDS
            else torch.empty(0, dtype=t.dtype).numpy().dtype)


class Checkpointer:
    """Saves/restores a chain carry + streamed history between segments.

    Each history chunk file is written exactly once (chunks are append-only
    across a run), so a run of S segments costs O(total history) chunk I/O,
    not O(S^2).  All writes are atomic (``mkstemp`` + ``os.replace``), chunk
    files land before the main npz that references them, and
    :meth:`restore` reads only as many chunk files as the main npz records:
    a crash mid-save is never read back inconsistently.  A write that fails
    raises.

    ``min_interval_s`` rate-limits saves by wall clock (a save copies the
    whole carry to the host); a kill then loses at most that much progress.
    Resume correctness does not depend on the cadence.
    """

    def __init__(self, directory: str, tag: str = "chain", every: int = 1,
                 min_segments: int = 2, min_interval_s: float = 0.0):
        self.directory = directory
        self.tag = tag
        self.every = max(1, every)
        self.min_segments = min_segments
        self.min_interval_s = float(min_interval_s)
        self._chunks_on_disk = 0   # this process's append-only watermark
        self._last_save_t = None
        self.history_bytes_written = 0  # lifetime chunk-file bytes
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.tag}.npz")

    def chunk_path(self, idx: int, fingerprint: str = "") -> str:
        # The fingerprint in the name keeps a reused tag's half-written new
        # chunk files from ever being read against an older run's main npz.
        fp = fingerprint[:8] or "nofp"
        return os.path.join(self.directory, f"{self.tag}.{fp}.hist{idx}.npy")

    def _write_atomic(self, final_path: str, write_fn) -> None:
        with profiling.span("mcq.checkpoint.write"):
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    write_fn(f)
                os.replace(tmp, final_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)

    def save(self, carry, segments_done: int, history_chunks,
             seg_outer: int = -1, fingerprint: str = "",
             extras=()) -> None:
        global SAVES
        if segments_done % self.every != 0:
            return
        now = time.monotonic()
        if (self.min_interval_s > 0 and self._last_save_t is not None
                and now - self._last_save_t < self.min_interval_s):
            return
        self._last_save_t = now
        # Chunks are append-only within a run: write only the new ones.  A
        # shrunk list means the tag was reused by a new run: rewrite all.
        if len(history_chunks) < self._chunks_on_disk:
            self._chunks_on_disk = 0
        for idx in range(self._chunks_on_disk, len(history_chunks)):
            arr = np.asarray(history_chunks[idx])
            self._write_atomic(self.chunk_path(idx, fingerprint),
                               lambda f, a=arr: np.save(f, a))
            self.history_bytes_written += arr.nbytes
        self._chunks_on_disk = len(history_chunks)

        payload = {f"carry_{name}": _to_numpy(name, val)
                   for name, val in _fields(carry).items() if val is not None}
        payload["segments_done"] = np.asarray(segments_done)
        payload["seg_outer"] = np.asarray(seg_outer)
        payload["fingerprint"] = np.asarray(fingerprint)
        payload["n_history_chunks"] = np.asarray(len(history_chunks))
        for idx, extra in enumerate(extras):
            # Caller-defined side state (tempering's betas row and, with
            # record_betas, the accumulated beta history).
            payload[f"extra_{idx}"] = np.asarray(extra)
        self._write_atomic(self.path, lambda f: np.savez(f, **payload))
        SAVES += 1

    def restore(self, template_carry, seg_outer: int = -1,
                fingerprint: str = "", n_extras: int = 0):
        """Return (carry, segments_done, history_chunks[, extras]) or None.

        With ``n_extras > 0`` the return gains a fourth element: the tuple of
        extra arrays stored by :meth:`save` (a checkpoint missing them is
        stale).

        ``template_carry`` gives the carry's type, its ``None`` fields and
        each field's device and dtype: every restored field is a contiguous
        tensor on the template's device with the template's dtype.  A
        checkpoint whose fingerprint differs (tag reuse across a config
        change), whose fields do not match the template's shapes and dtypes,
        whose segmentation differs (a different segment size would misalign
        steps), or whose history chunks are lost is ignored, not loaded
        wrong.
        """
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as data:
            if "seg_outer" in data and int(data["seg_outer"]) != seg_outer:
                return None
            stored_fp = str(data["fingerprint"]) if "fingerprint" in data else ""
            if stored_fp != fingerprint:
                return None  # stale checkpoint from a different run config
            fields = {}
            for name, val in _fields(template_carry).items():
                key = f"carry_{name}"
                if key not in data:
                    if val is not None:
                        return None  # stale checkpoint from another carry type
                    fields[name] = None
                    continue
                if val is None:
                    return None  # the template has no such field to fill
                arr = data[key]
                if (arr.shape != tuple(val.shape)
                        or arr.dtype != _stored_dtype(name, val)):
                    return None  # stale checkpoint from another config
                if name in KEY_FIELDS:
                    arr = arr.astype(np.int64)
                fields[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=val.device, dtype=val.dtype).contiguous()
            segments_done = int(data["segments_done"])
            n_chunks = int(data["n_history_chunks"])
            chunks = []
            for i in range(n_chunks):
                cp = self.chunk_path(i, fingerprint)
                if not os.path.exists(cp):
                    return None  # chunk file lost: treat as no checkpoint
                chunks.append(np.load(cp))
            if n_extras:
                if any(f"extra_{i}" not in data for i in range(n_extras)):
                    return None  # stale checkpoint without the side state
                extras = tuple(data[f"extra_{i}"] for i in range(n_extras))
        carry = type(template_carry)(**fields)
        self._chunks_on_disk = n_chunks
        if n_extras:
            return carry, segments_done, chunks, extras
        return carry, segments_done, chunks

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        pattern = os.path.join(self.directory, f"{self.tag}.*.hist*.npy")
        for p in glob.glob(pattern):
            os.unlink(p)
        self._chunks_on_disk = 0
