"""Checkpoint integrity manifests, atomic ``latest`` tags, retention GC
(the port's own copy of ``deepspeed_tpu/runtime/resilience/manifest.py``,
which it may not import; the file format is the same, so a tag written
by either package verifies under the other).

Durability must be verified, not assumed: a checkpoint directory on a
shared filesystem can hold torn writes (truncated files from a crash
mid-save, or a ``latest`` tag pointing at a save that never finished).
Every save therefore writes a ``manifest.json`` at the tag root listing
each file's size and digest; every load verifies the manifest before
restoring and, on mismatch, walks the retained-tag chain to the newest
*verified-good* checkpoint instead of crashing.

Standard library only: verification is pure file I/O.

Layout under ``save_dir``::

    save_dir/latest              <- tag name, written atomically
    save_dir/<tag>/manifest.json <- this module's integrity record
    save_dir/<tag>/state.pt      <- the engine state (opaque here)
    save_dir/<tag>/engine_meta.json
"""

import hashlib
import json
import os
import shutil
import zlib
from typing import Dict, List, Optional, Tuple

from ..config_utils import logger

MANIFEST_FILE = "manifest.json"
LATEST_FILE = "latest"      # single source of truth; checkpointing imports it
QUARANTINE_FILE = MANIFEST_FILE + ".quarantined"
MANIFEST_VERSION = 1
_CHUNK = 1 << 20


class CheckpointCorruptionError(Exception):
    """A checkpoint failed integrity verification and no verified-good
    fallback tag exists."""


def _digest_file(path: str, algorithm: str) -> str:
    if algorithm == "crc32":
        crc = 0
        with open(path, "rb") as f:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
        return f"{crc & 0xFFFFFFFF:08x}"
    if algorithm == "sha256":
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                h.update(chunk)
        return h.hexdigest()
    raise ValueError(f"unknown digest algorithm {algorithm!r}")


def _walk_files(tag_path: str) -> List[str]:
    """Relative paths of every file under the tag dir, except the manifest
    itself (it cannot self-certify). Sorted for a stable manifest."""
    out = []
    for root, _dirs, files in os.walk(tag_path):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), tag_path)
            if rel != MANIFEST_FILE:
                out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def write_manifest(tag_path: str, *, step: Optional[int] = None,
                   tag: Optional[str] = None,
                   algorithm: str = "crc32") -> str:
    """Record every file under ``tag_path`` (size + digest) into
    ``manifest.json``. Written tmp-then-replace so a crash mid-write
    leaves either no manifest (tag unverifiable -> skipped by the
    fallback walk) or a complete one — never a torn manifest that
    'verifies' garbage."""
    files: Dict[str, Dict[str, object]] = {}
    for rel in _walk_files(tag_path):
        full = os.path.join(tag_path, rel)
        files[rel] = {"size": os.path.getsize(full),
                      "digest": _digest_file(full, algorithm)}
    manifest = {
        "version": MANIFEST_VERSION,
        "tag": tag if tag is not None else os.path.basename(tag_path),
        "step": step,
        "algorithm": algorithm,
        "framework_version": _framework_version(),
        "files": files,
    }
    path = os.path.join(tag_path, MANIFEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(tag_path)
    return path


def _framework_version() -> str:
    try:
        from ... import __version__
        return __version__
    except ImportError:
        return "unknown"


def read_manifest(tag_path: str) -> Optional[dict]:
    """The parsed manifest, or None when absent/unparseable (a torn
    manifest means the tag is unverifiable, not that verification
    should crash)."""
    path = os.path.join(tag_path, MANIFEST_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        logger.warning(f"unreadable checkpoint manifest {path}: {e}")
        return None


def verify_manifest(tag_path: str) -> List[str]:
    """Check every manifest-listed file's existence, size, and digest.
    Returns the list of mismatch descriptions — empty means verified.
    A missing manifest is itself a finding (the tag is unverifiable)."""
    manifest = read_manifest(tag_path)
    if manifest is None:
        return [f"no readable {MANIFEST_FILE} under {tag_path}"]
    algorithm = manifest.get("algorithm", "crc32")
    if algorithm not in ("crc32", "sha256"):
        # corrupted field, or a newer framework's algorithm: the tag is
        # unverifiable — a verification ERROR, never a crash (the fallback
        # machinery must survive exactly this kind of damaged metadata)
        return [f"unknown digest algorithm {algorithm!r} in manifest"]
    errors = []
    for rel, rec in manifest.get("files", {}).items():
        full = os.path.join(tag_path, rel)
        if not os.path.isfile(full):
            errors.append(f"{rel}: missing")
            continue
        size = os.path.getsize(full)
        if size != rec.get("size"):
            errors.append(f"{rel}: size {size} != manifest {rec.get('size')}"
                          " (torn write?)")
            continue
        digest = _digest_file(full, algorithm)
        if digest != rec.get("digest"):
            errors.append(f"{rel}: {algorithm} {digest} != manifest "
                          f"{rec.get('digest')}")
    return errors


def manifest_step(tag_path: str) -> Optional[int]:
    manifest = read_manifest(tag_path)
    return manifest.get("step") if manifest else None


def list_tags(save_dir: str) -> List[Tuple[str, Optional[int]]]:
    """Every tag directory under ``save_dir`` paired with its manifest
    step (None for unmanifested tags), newest first — manifested tags
    ordered by step, unmanifested tags last by mtime."""
    entries = []
    if not os.path.isdir(save_dir):
        return entries
    for name in os.listdir(save_dir):
        path = os.path.join(save_dir, name)
        if not os.path.isdir(path):
            continue
        step = manifest_step(path)
        mtime = os.path.getmtime(path)
        entries.append((name, step, mtime))
    entries.sort(key=lambda e: (e[1] is not None,
                                e[1] if e[1] is not None else 0, e[2]),
                 reverse=True)
    return [(name, step) for name, step, _ in entries]


def resolve_verified_tag(save_dir: str, prefer_tag: Optional[str] = None
                         ) -> Tuple[Optional[str], Dict[str, List[str]]]:
    """The tag to restore: ``prefer_tag`` when it verifies (or carries no
    manifest — legacy saves stay loadable), else the newest tag whose
    manifest verifies. Returns (tag, {tag: errors}) where the error map
    covers every rejected candidate; (None, errors) when nothing
    survives."""
    errors: Dict[str, List[str]] = {}
    candidates = []
    if prefer_tag is not None:
        candidates.append(prefer_tag)
    candidates.extend(t for t, _ in list_tags(save_dir)
                      if t not in candidates)
    for tag in candidates:
        tag_path = os.path.join(save_dir, tag)
        if not os.path.isdir(tag_path):
            errors[tag] = ["tag directory does not exist"]
            continue
        if os.path.isfile(os.path.join(tag_path, QUARANTINE_FILE)):
            # integrity-valid but numerically unhealthy (a rollback landed
            # on it and found non-finite params): never restore it again,
            # not even as an explicitly requested legacy tag
            errors[tag] = ["quarantined (restored params were non-finite)"]
            continue
        if read_manifest(tag_path) is None:
            if tag == prefer_tag:
                # pre-manifest checkpoint explicitly (or via latest)
                # requested: integrity cannot be checked, honor it
                return tag, errors
            errors[tag] = [f"no {MANIFEST_FILE} (unverifiable)"]
            continue
        errs = verify_manifest(tag_path)
        if not errs:
            return tag, errors
        errors[tag] = errs
    return None, errors


def quarantine_tag(tag_path: str) -> None:
    """Mark an integrity-valid tag as numerically unhealthy: the manifest
    is renamed aside, so the tag drops out of the fallback walk (and the
    prefer-tag legacy path — ``resolve_verified_tag`` checks the marker)
    while its files stay on disk for post-mortem. Used by rollback when a
    restored checkpoint turns out to hold non-finite params — a save that
    landed inside an undetected divergence window."""
    src = os.path.join(tag_path, MANIFEST_FILE)
    if os.path.isfile(src):
        os.replace(src, os.path.join(tag_path, QUARANTINE_FILE))
    else:
        # legacy/unmanifested tag: the marker alone blocks restoration
        with open(os.path.join(tag_path, QUARANTINE_FILE), "w") as f:
            f.write("{}")
    logger.warning(f"checkpoint quarantined (non-finite params): {tag_path}")


def write_latest(save_dir: str, tag: str) -> None:
    """Publish the ``latest`` tag durably: tmp file + fsync + atomic
    ``os.replace`` + directory fsync. A crash at any point leaves either
    the previous ``latest`` or the new one — never a truncated tag file
    that breaks every future load."""
    path = os.path.join(save_dir, LATEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(tag))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(save_dir)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (POSIX); some
    filesystems/platforms refuse O_RDONLY dir fsync — degrade silently,
    the rename itself is still atomic."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def gc_checkpoints(save_dir: str, keep_last_n: int,
                   protect: Tuple[str, ...] = ()) -> List[str]:
    """Delete the oldest *manifested* tag directories beyond
    ``keep_last_n``, never touching ``protect`` entries, the tag
    ``latest`` points at, or unmanifested directories (they may be user
    data this framework does not own). Returns the removed tag names."""
    if keep_last_n <= 0:
        return []
    protected = set(protect)
    latest_path = os.path.join(save_dir, LATEST_FILE)
    if os.path.isfile(latest_path):
        try:
            with open(latest_path) as f:
                protected.add(f.read().strip())
        except OSError:
            pass
    managed = [t for t, step in list_tags(save_dir) if step is not None]
    removed = []
    for tag in managed[keep_last_n:]:
        if tag in protected:
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        removed.append(tag)
    if removed:
        logger.info(f"checkpoint GC (keep_last_n={keep_last_n}): removed "
                    f"{removed}")
    return removed
