"""Preemption-safe checkpoints of a run (own port of
tmhpvsim_tpu/engine/checkpoint.py, in its file format).

A run's whole state is the chain state and, in reduce mode, the
accumulator, plus the index of the next block; every draw is keyed by a
global index, so ``save -> restart -> load -> resume`` gives the
uninterrupted run's bits.

The format is the JAX package's, so that a checkpoint written by either
package resumes in the other:

* each snapshot is one ``.npz`` of '/'-joined tree paths, in the JAX
  package's layout (``engine/convert.py``): float32 and int32 leaves as
  they are, and the key leaves (``convert.KEY_LEAVES``, marked by name:
  the port has no key type) as uint32 key data under a ``key:`` prefix;
  ``__meta__`` holds the JSON record of the resume point, the key
  implementation (always the config's, never inferred from the key
  width: rbg and unsafe_rbg data are both 4 words wide), the config echo
  and the chain layout;
* ``PATH`` is the anchor, a hard link to the newest generation;
  ``PATH.g<N>`` are the generations, the newest ``keep`` of them kept;
  ``PATH.manifest.json`` records each generation's size, CRC32, sha256
  and resume block.  ``load`` verifies the newest generation against it
  and falls back generation by generation past a torn or altered one (a
  warning and the blocks since the older generation lost, never a dead
  run); a file without a manifest is a legacy single file and loads as
  generation 0;
* the snapshot is fsync'd before its rename and the directory after it
  and after the manifest's rewrite, so a crash at any instant leaves the
  newest verified generation loadable.

``save`` records where the file's chains sit in the run (``layout``:
which global chains ``[chain_start, chain_stop)`` of ``n_chains``, under
how many processes and cards), apart from the identity echo
(``_config_echo``): an identity mismatch refuses the resume with the
differing keys, a placement difference never does.  ``load_elastic``
reassembles a sharded run's per-process ``PATH.host<i>`` files into the
whole chain axis and slices what a resuming process holds.

``AsyncCheckpointWriter`` takes the snapshot on the caller's thread (the
device-to-host copies, enqueued) and writes it on a thread of its own,
as the JAX package's does.  The JAX package's fault-injection
chokepoints around the write wait for the port's ``runtime/faults.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from tmhpvsim_torch.engine.convert import KEY_LEAVES
from tmhpvsim_torch.obs import metrics as obs_metrics
from tmhpvsim_torch.rng import KEY_WIDTH

logger = logging.getLogger(__name__)

#: generations retained by ``save`` when the caller does not say
DEFAULT_KEEP = 3

#: version of the random-stream layout (how draws derive from keys and
#: global indices), the JAX package's: a checkpoint of another layout is
#: refused by the config check, never resumed onto other randomness
RNG_STREAM_VERSION = 3

_KEY_PREFIX = "key:"
_META = "__meta__"

#: sidecar manifest format (the JAX package's)
MANIFEST_FORMAT = 1


def manifest_path(path: str) -> str:
    return path + ".manifest.json"


def _dir_of(path: str) -> str:
    return os.path.dirname(path) or "."


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory entry (a no-op where directories refuse it)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _digest(path: str) -> Tuple[int, int, str]:
    """(size, crc32, sha256-hex) of a file, streamed."""
    crc = 0
    sha = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            crc = zlib.crc32(chunk, crc)
            sha.update(chunk)
    return size, crc & 0xFFFFFFFF, sha.hexdigest()


def read_manifest(path: str) -> Optional[dict]:
    """The manifest of checkpoint ``path``, or None when it is absent or
    unreadable (then the checkpoint loads as a legacy single file)."""
    mp = manifest_path(path)
    try:
        with open(mp) as f:
            man = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        logger.warning("checkpoint manifest %s unreadable (%s); "
                       "treating checkpoint as a legacy single file",
                       mp, e)
        return None
    if not isinstance(man, dict) or \
            not isinstance(man.get("generations"), list):
        logger.warning("checkpoint manifest %s malformed; treating "
                       "checkpoint as a legacy single file", mp)
        return None
    return man


def _write_manifest(path: str, man: dict) -> None:
    mp = manifest_path(path)
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mp)
    _fsync_dir(_dir_of(path))


def _point_anchor(path: str, gpath: str) -> None:
    """Make the anchor ``path`` the newest generation, atomically: a hard
    link, or a copy where the filesystem has none."""
    lnk = path + ".lnk.tmp"
    with contextlib.suppress(FileNotFoundError):
        os.remove(lnk)
    try:
        os.link(gpath, lnk)
    except OSError:
        shutil.copyfile(gpath, lnk)
        with open(lnk, "rb") as f:
            with contextlib.suppress(OSError):
                os.fsync(f.fileno())
    os.replace(lnk, path)


def _write_generation(path: str, flat: dict, meta: dict,
                      keep: int) -> Tuple[int, int]:
    """One durable rotation step: the npz to a temporary file, fsync'd and
    checksummed, promoted to ``path.g<N>``, the anchor re-pointed, the
    manifest rewritten and the generations beyond ``keep`` removed.
    Returns the generation and the generations kept."""
    d = _dir_of(path)
    man = read_manifest(path)
    gen = int((man or {}).get("latest", 0)) + 1
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat, **{_META: json.dumps(meta)})
        f.flush()
        os.fsync(f.fileno())
    size, crc, sha = _digest(tmp)
    gpath = f"{path}.g{gen}"
    os.replace(tmp, gpath)
    _fsync_dir(d)
    _point_anchor(path, gpath)
    _fsync_dir(d)
    entries = [e for e in (man or {}).get("generations", [])
               if isinstance(e, dict)
               and os.path.exists(os.path.join(d, e.get("file", "")))]
    entries.append({
        "gen": gen,
        "file": os.path.basename(gpath),
        "size": size,
        "crc32": crc,
        "sha256": sha,
        "next_block": int(meta.get("next_block", 0)),
        "saved_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    })
    keep = max(1, int(keep))
    kept, pruned = entries[-keep:], entries[:-keep]
    _write_manifest(path, {
        "format": MANIFEST_FORMAT,
        "keep": keep,
        "latest": gen,
        "generations": kept,
    })
    for e in pruned:
        with contextlib.suppress(OSError):
            os.remove(os.path.join(d, e["file"]))
    return gen, len(kept)


class CheckpointError(RuntimeError):
    """A checkpoint that cannot be used: missing, truncated, not an npz,
    or without metadata; the message carries the path, the size and a
    hint."""

    _HINT = ("delete the checkpoint (and its .manifest.json / .g* "
             "siblings) to start fresh, or point --checkpoint at the "
             "file that belongs to this run")

    def __init__(self, path: str, detail: str, *,
                 size: Optional[int] = None, hint: Optional[str] = None):
        self.path = path
        self.detail = detail
        self.size = size
        msg = f"checkpoint {path}: {detail}"
        if size is not None:
            msg += f" (size {size} bytes)"
        super().__init__(f"{msg} — {hint or self._HINT}")


class CheckpointCorruptError(CheckpointError):
    """No recorded generation passed verification."""


def _config_echo(config) -> dict:
    """The identity of a run: a resume whose config echoes differently is
    refused.  Plan knobs (formulation, slab size, blocks per dispatch)
    give the same bits and are not echoed; nor is placement, which rides
    ``meta['layout']``."""
    return {
        "start": config.start,
        "duration_s": config.duration_s,
        "n_chains": config.n_chains,
        "seed": config.seed,
        "block_s": config.block_s,
        "dtype": config.dtype,
        "prng_impl": config.prng_impl,
        "rng_stream": RNG_STREAM_VERSION,
        "site": dataclasses.asdict(config.site),
        "site_grid": (dataclasses.asdict(config.site_grid)
                      if config.site_grid is not None else None),
        "output": config.output,
        "options": dataclasses.asdict(config.options),
        "meter_max_w": config.meter_max_w,
        "fleet": ({"n": len(config.fleet),
                   "digest": config.fleet.digest()}
                  if config.fleet is not None else None),
    }


def _leaves(tree, prefix=""):
    """``(path, is a key leaf, leaf)`` of a nested dict, keys sorted at
    every level."""
    for name in sorted(tree):
        value = tree[name]
        path = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from _leaves(value, path + "/")
        else:
            yield path, name in KEY_LEAVES, value


class _Snapshot:
    """A state / accumulator tree copied to host memory (a save's, or an
    async submit's): card tensors into one pinned buffer (reused through torch's
    caching host allocator) by copies on the current stream, every other
    leaf at once.  ``flat()`` waits for the copies and gives the record
    in the JAX layout: '/' paths, key leaves as uint32 key data under
    ``key:``."""

    def __init__(self, tree):
        leaves = list(_leaves(tree))
        card = [(p, v) for p, _, v in leaves
                if isinstance(v, torch.Tensor) and v.is_cuda]
        self._buf = self._event = None
        host = {}
        if card:
            # 8-byte aligned slots, so that every leaf's view is aligned
            size = [-(-v.numel() * v.element_size() // 8) * 8
                    for _, v in card]
            ends = np.cumsum([0] + size)
            self._buf = torch.empty(int(ends[-1]), dtype=torch.uint8,
                                    pin_memory=True)
            for (p, v), lo in zip(card, ends[:-1]):
                n = v.numel() * v.element_size()
                dst = self._buf[lo:lo + n].view(v.dtype).view(v.shape)
                dst.copy_(v.detach(), non_blocking=True)
                host[p] = dst
            self._event = torch.cuda.Event()
            self._event.record()
        self._leaves = []
        for p, key, v in leaves:
            if p in host:
                h = host[p]
            elif isinstance(v, torch.Tensor):
                h = v.detach().to("cpu", copy=True)
            else:
                h = np.array(v)
            self._leaves.append((p, key, h))

    def key_shapes(self) -> dict:
        """``{path: shape}`` of the key leaves (no wait)."""
        return {p: tuple(h.shape) for p, key, h in self._leaves if key}

    def flat(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        out = {}
        for p, key, h in self._leaves:
            a = h.numpy() if isinstance(h, torch.Tensor) else h
            if key:
                out[_KEY_PREFIX + p] = a.astype(np.uint32)
            else:
                out[p] = a
        return out


def _flatten(tree) -> dict:
    """``{path: numpy}`` of a state / accumulator tree in the JAX layout
    (``_Snapshot.flat``), a host copy."""
    return _Snapshot(tree).flat()


def _unflatten(flat) -> dict:
    """The nested numpy tree of a flat record (key leaves as uint32 key
    data: ``Simulation._place_resume`` checks their width against the
    run's key implementation)."""
    tree = {}
    for path, value in flat.items():
        if path.startswith(_KEY_PREFIX):
            path = path[len(_KEY_PREFIX):]
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _build_meta(key_shapes: dict, next_block: int, config, layout,
                echo: Optional[dict] = None) -> dict:
    """The ``__meta__`` record (``echo``: the config's echo, when the
    caller keeps it).  The key implementation comes from the config: a
    save without one raises (key data does not say whether it is rbg or
    unsafe_rbg), and so do key leaves (``{path: shape}``) of another
    width."""
    if config is None:
        raise ValueError(
            "checkpoint.save needs the run's config: the key "
            "implementation is written from it, never guessed from the "
            "key width")
    width = KEY_WIDTH[config.prng_impl]
    for k, shape in key_shapes.items():
        if shape[-1:] != (width,):
            raise ValueError(f"{k}: {shape} is not {config.prng_impl} key "
                             "data")
    meta = {"next_block": int(next_block),
            "prng_impl": config.prng_impl,
            "config": _config_echo(config) if echo is None else echo}
    if layout is not None:
        meta["layout"] = dict(layout)
    return meta


def save(path: str, state, next_block: int, config=None, *,
         keep: Optional[int] = None, layout: Optional[dict] = None) -> None:
    """Write ``state`` (a state, or ``{"state", "acc"}``; tensors or
    numpy) with its resume point ``next_block`` as a new generation of
    ``path``.  ``config`` is required (its key implementation and echo are
    written); ``keep`` bounds the generations kept (default
    :data:`DEFAULT_KEEP`); ``layout`` is ``Simulation.checkpoint_layout()``."""
    reg = obs_metrics.get_registry()
    with reg.timed("checkpoint.save_s"):
        snap = _Snapshot(state)
        meta = _build_meta(snap.key_shapes(), next_block, config, layout)
        gen, kept = _write_generation(path, snap.flat(), meta,
                                      DEFAULT_KEEP if keep is None else keep)
    reg.gauge("checkpoint.generations").set(kept)
    reg.gauge("checkpoint.latest_generation").set(gen)


def _size_of(path: str) -> Optional[int]:
    try:
        return os.path.getsize(path)
    except OSError:
        return None


def _read_npz(fpath: str) -> Tuple[dict, dict]:
    with np.load(fpath, allow_pickle=False) as data:
        meta = json.loads(str(data[_META]))
        flat = {k: data[k] for k in data.files if k != _META}
    return flat, meta


def _verify_entry(fpath: str, entry: dict) -> Optional[str]:
    """None when ``fpath`` matches its manifest entry, else what failed
    (missing / size / crc32 / sha256)."""
    try:
        st_size = os.path.getsize(fpath)
    except OSError as e:
        return f"missing ({e.__class__.__name__})"
    want_size = entry.get("size")
    if want_size is not None and st_size != want_size:
        return f"size {st_size} != recorded {want_size}"
    size, crc, sha = _digest(fpath)
    if entry.get("crc32") is not None and crc != entry["crc32"]:
        return f"crc32 {crc:#010x} != recorded {entry['crc32']:#010x}"
    if entry.get("sha256") is not None and sha != entry["sha256"]:
        return "sha256 mismatch"
    return None


def _check_config(meta: dict, config) -> None:
    """Refuse a checkpoint whose echo differs from ``config``'s, naming
    the keys (an echo without a later-added key compares as that key's
    value then, as in the JAX package; no ``rng_stream`` is layout 1)."""
    if config is None or "config" not in meta:
        return
    saved = meta["config"]
    saved.setdefault("site_grid", None)
    saved.setdefault("output", "trace")
    saved.setdefault("prng_impl", "threefry2x32")
    saved.setdefault("rng_stream", 1)
    saved.setdefault("fleet", None)
    current = json.loads(json.dumps(_config_echo(config)))  # tuple->list
    if saved != current:
        miss = object()
        diffs = {k: (saved.get(k, miss), current.get(k, miss))
                 for k in sorted(set(saved) | set(current))
                 if saved.get(k, miss) != current.get(k, miss)}
        raise ValueError(
            f"checkpoint was written by a different configuration: "
            f"{diffs}")


def _load_verified(path: str, config=None,
                   want_block: Optional[int] = None) -> Tuple[dict, dict]:
    """(flat, meta) of the newest generation that verifies against the
    manifest, falling back generation by generation (a warning and the
    ``checkpoint.verify_fail_total`` / ``checkpoint.fallback_total``
    counters); :class:`CheckpointCorruptError` when none does.  Without a
    manifest the file loads as a legacy single file.  ``want_block``
    keeps only generations of that resume point (aligning a sharded run's
    stragglers)."""
    reg = obs_metrics.get_registry()
    d = _dir_of(path)
    man = read_manifest(path)
    if man is not None:
        entries = sorted(
            (e for e in man["generations"] if isinstance(e, dict)),
            key=lambda e: e.get("gen", 0), reverse=True)
        if want_block is not None:
            entries = [e for e in entries
                       if e.get("next_block") == want_block]
        newest_nb = entries[0].get("next_block") if entries else None
        tried: List[str] = []
        for e in entries:
            fpath = os.path.join(d, e.get("file", ""))
            if not os.path.exists(fpath) and \
                    e.get("gen") == man.get("latest") and \
                    os.path.exists(path):
                fpath = path  # the anchor survives a lost .g file
            bad = _verify_entry(fpath, e)
            if bad is None:
                try:
                    flat, meta = _read_npz(fpath)
                except Exception as exc:
                    bad = (f"verified but unreadable "
                           f"({exc.__class__.__name__}: {exc})")
            if bad is not None:
                reg.counter("checkpoint.verify_fail_total").inc()
                logger.warning(
                    "checkpoint %s generation %s failed verification: %s",
                    path, e.get("gen"), bad)
                tried.append(f"g{e.get('gen')}: {bad}")
                continue
            if tried:
                reg.counter("checkpoint.fallback_total").inc()
                lost = ""
                if isinstance(newest_nb, int) and \
                        isinstance(e.get("next_block"), int):
                    lost = (f"; {newest_nb - e['next_block']} block(s) "
                            f"of progress lost")
                logger.warning(
                    "checkpoint %s: falling back to generation %s "
                    "(resumes at block %s%s)", path, e.get("gen"),
                    e.get("next_block"), lost)
            _check_config(meta, config)
            return flat, meta
        raise CheckpointCorruptError(
            path, "no generation passed integrity verification "
                  f"[{'; '.join(tried) or 'manifest lists none'}]",
            size=_size_of(path))
    try:
        flat, meta = _read_npz(path)
    except FileNotFoundError as exc:
        raise CheckpointError(path, "missing") from exc
    except Exception as exc:
        raise CheckpointError(
            path, f"unreadable as a checkpoint npz "
                  f"({exc.__class__.__name__}: {exc})",
            size=_size_of(path)) from exc
    _check_config(meta, config)
    return flat, meta


def _candidates(path: str):
    """Files that may hold this checkpoint's metadata, best first: the
    anchor, the manifest's generations newest first, then the per-process
    shards' (a sharded run has no combined anchor)."""
    if os.path.exists(path):
        yield path
    man = read_manifest(path)
    if man is not None:
        d = _dir_of(path)
        for e in sorted((e for e in man["generations"]
                         if isinstance(e, dict)),
                        key=lambda e: e.get("gen", 0), reverse=True):
            fp = os.path.join(d, e.get("file", ""))
            if fp != path and os.path.exists(fp):
                yield fp
    for sp in _shard_paths(path):
        yield from _candidates(sp)


def peek_meta(path: str) -> dict:
    """The metadata record of the newest readable generation (no
    checksums: the CLI peeks for the seed, not for integrity)."""
    last: Optional[BaseException] = None
    for fpath in _candidates(path):
        try:
            with np.load(fpath, allow_pickle=False) as data:
                return json.loads(str(data[_META]))
        except Exception as exc:
            last = exc
    if last is None:
        raise CheckpointError(path, "missing")
    raise CheckpointError(
        path, f"no readable metadata in any generation "
              f"({last.__class__.__name__}: {last})",
        size=_size_of(path)) from last


def resumable(path: str) -> bool:
    """True when a run can resume from ``path``: the anchor exists, the
    manifest names a surviving generation, or per-process
    ``path.host<i>`` shards exist."""
    if os.path.exists(path):
        return True
    man = read_manifest(path)
    if man is not None:
        d = _dir_of(path)
        if any(os.path.exists(os.path.join(d, e.get("file", "")))
               for e in man["generations"] if isinstance(e, dict)):
            return True
    return any(resumable(sp) for sp in _shard_paths(path))


def _shard_paths(path: str) -> List[str]:
    """The per-process shard anchors ``path.host<i>``, in process order."""
    found = []
    pat = re.compile(re.escape(path) + r"\.host(\d+)$")
    for p in glob.glob(glob.escape(path) + ".host*"):
        m = pat.match(p)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def load(path: str, config=None) -> Tuple[dict, int]:
    """``(tree, next_block)``: the newest generation that verifies, its
    config echo checked against ``config`` when given.  The tree is numpy
    in the JAX layout (``Simulation`` places it on the run's device)."""
    with obs_metrics.get_registry().timed("checkpoint.restore_s"):
        flat, meta = _load_verified(path, config)
    return _finish_load(path, flat, meta)


def _finish_load(path: str, flat: dict, meta: dict) -> Tuple[dict, int]:
    nb = meta.get("next_block")
    if not isinstance(nb, int):
        raise CheckpointError(path, "metadata lacks a next_block resume "
                                    "point")
    return _unflatten(flat), nb


def _shard_chains(flat: dict, layout: Optional[dict]) -> int:
    """A file's chain count: from its layout, else from a key leaf
    (``(n_chains, words)``)."""
    if layout and isinstance(layout.get("chain_start"), int) and \
            isinstance(layout.get("chain_stop"), int):
        return layout["chain_stop"] - layout["chain_start"]
    for k, v in flat.items():
        if k.startswith(_KEY_PREFIX) and getattr(v, "ndim", 0) >= 1:
            return int(v.shape[0])
    raise CheckpointError(
        "<shard>", "cannot infer the shard's chain count (no layout "
                   "metadata and no per-chain key leaf)")


def _assemble_shards(path: str, shards: List[str],
                     config) -> Tuple[dict, dict]:
    """The per-process shards of ``path`` as one chain axis: per-chain
    leaves concatenated in chain order, the others taken from the first.
    Shards whose newest generations disagree on the resume point align on
    the oldest common block (each shard keeps generations to find it)."""
    loaded = []
    for sp in shards:
        flat, meta = _load_verified(sp, config)
        loaded.append([sp, flat, meta])
    blocks = {m.get("next_block") for _, _, m in loaded}
    if len(blocks) > 1:
        nb = min(b for b in blocks if isinstance(b, int))
        logger.warning(
            "checkpoint shards of %s disagree on the resume point %s; "
            "aligning all shards on block %d", path, sorted(blocks), nb)
        for rec in loaded:
            if rec[2].get("next_block") != nb:
                try:
                    rec[1], rec[2] = _load_verified(rec[0], config,
                                                    want_block=nb)
                except CheckpointError as exc:
                    raise CheckpointCorruptError(
                        path, f"shard {rec[0]} has no generation at the "
                              f"common resume block {nb} ({exc.detail})"
                    ) from exc

    def start_of(rec):
        lay = rec[2].get("layout") or {}
        return lay.get("chain_start", shards.index(rec[0]))

    loaded.sort(key=start_of)
    sizes = [_shard_chains(flat, meta.get("layout"))
             for _, flat, meta in loaded]
    lays = [m.get("layout") or {} for _, _, m in loaded]
    if all(isinstance(lay.get("chain_start"), int) for lay in lays):
        pos = 0
        for lay, n in zip(lays, sizes):
            if lay["chain_start"] != pos:
                raise CheckpointError(
                    path, f"shard chain slices are not contiguous: "
                          f"expected a shard starting at chain {pos}, "
                          f"found [{lay['chain_start']}, "
                          f"{lay.get('chain_stop')})")
            pos += n
    out = {}
    for k, v0 in loaded[0][1].items():
        if getattr(v0, "ndim", 0) >= 1 and v0.shape[0] == sizes[0]:
            out[k] = np.concatenate([flat[k] for _, flat, _ in loaded],
                                    axis=0)
        else:
            out[k] = v0
    meta = dict(loaded[0][2])
    lay = dict(lays[0]) if lays[0] else {}
    total = sum(sizes)
    lay.update(n_chains=lay.get("n_chains", total),
               chain_start=0, chain_stop=total)
    meta["layout"] = lay
    return out, meta


def _slice_chains(path: str, flat: dict, meta: dict,
                  chain_slice: Tuple[int, int]) -> Tuple[dict, dict]:
    """A loaded flat record restricted to the global chains ``[a, b)``."""
    a, b = int(chain_slice[0]), int(chain_slice[1])
    lay = meta.get("layout") or {}
    cur_a = lay.get("chain_start", 0)
    n_cur = _shard_chains(flat, lay if lay else None)
    cur_b = lay.get("chain_stop", cur_a + n_cur)
    if (cur_a, cur_b) == (a, b):
        return flat, meta
    if not (cur_a <= a and b <= cur_b):
        raise CheckpointError(
            path, f"holds chains [{cur_a}, {cur_b}) which does not cover "
                  f"the requested slice [{a}, {b})",
            hint="resume with the checkpoint that holds these chains, "
                 "or reassemble the full run from its .hostN shards")
    off = a - cur_a
    out = {k: (v[off:off + (b - a)]
               if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n_cur
               else v)
           for k, v in flat.items()}
    meta = dict(meta)
    lay = dict(lay)
    lay.update(chain_start=a, chain_stop=b)
    meta["layout"] = lay
    return out, meta


def load_elastic(path: str, config=None, *,
                 chain_slice: Optional[Tuple[int, int]] = None
                 ) -> Tuple[dict, int]:
    """:func:`load` under another placement than the save's: the anchor
    or manifest of ``path`` when there is one, else its ``path.host<i>``
    shards reassembled; then, with ``chain_slice=(a, b)``, the global
    chains ``[a, b)`` only.  The config echo is checked per file."""
    with obs_metrics.get_registry().timed("checkpoint.restore_s"):
        if os.path.exists(path) or read_manifest(path) is not None:
            flat, meta = _load_verified(path, config)
        else:
            shards = _shard_paths(path)
            if not shards:
                raise CheckpointError(
                    path, "missing (no anchor, no manifest generation, "
                          "no .host<i> shards)")
            flat, meta = _assemble_shards(path, shards, config)
        if chain_slice is not None:
            flat, meta = _slice_chains(path, flat, meta, chain_slice)
    return _finish_load(path, flat, meta)


class AsyncCheckpointWriter:
    """Checkpoint writes off the run's thread (the JAX package's design).

    ``submit`` takes the snapshot on the caller's thread (``_Snapshot``:
    the card tensors' copies into one pinned host buffer, enqueued on the
    current stream before the run's next launches, not waited for) and
    hands it to a daemon thread, which waits for the copies and
    serialises, checksums, fsyncs, rotates and commits: the writer never
    holds a tensor the run goes on updating.  Latest-wins queue of depth
    one: a submit while a snapshot still waits replaces it
    (``checkpoint.async_dropped_total`` counts the replaced ones), so a
    slow disk lowers the checkpoint cadence, never the block walls.  A
    failed write warns and counts
    (``checkpoint.async_write_failures_total``); :meth:`close` drains the
    queue and raises when the last write failed, so a run never ends
    without its final checkpoint on disk."""

    def __init__(self, path: str, *, config=None,
                 keep: Optional[int] = None):
        self.path = path
        self.config = config
        self.keep = DEFAULT_KEEP if keep is None else keep
        self._reg = obs_metrics.get_registry()
        self._depth = self._reg.gauge("checkpoint.async_queue_depth")
        self._echo = None  # the config's echo, made at the first submit
        self._cond = threading.Condition()
        self._pending: Optional[Tuple[_Snapshot, dict]] = None
        self._busy = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run,
                                        name="ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, state, next_block: int,
               layout: Optional[dict] = None) -> None:
        """Snapshot ``state`` and queue its write; returns once the copies
        are enqueued (on the card) or made."""
        if self._echo is None and self.config is not None:
            self._echo = _config_echo(self.config)
        snap = _Snapshot(state)
        meta = _build_meta(snap.key_shapes(), next_block, self.config,
                           layout, self._echo)
        with self._cond:
            if self._pending is not None:
                self._reg.counter("checkpoint.async_dropped_total").inc()
            self._pending = (snap, meta)
            self._depth.set(1 + self._busy)
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None:
                    return  # stopped and drained
                snap, meta = self._pending
                self._pending = None
                self._busy = True
                self._depth.set(1)
            err: Optional[BaseException] = None
            try:
                with self._reg.timed("checkpoint.save_s"):
                    gen, kept = _write_generation(self.path, snap.flat(),
                                                  meta, self.keep)
                self._reg.counter("checkpoint.async_saves_total").inc()
                self._reg.gauge("checkpoint.generations").set(kept)
                self._reg.gauge("checkpoint.latest_generation").set(gen)
            except BaseException as e:  # raised at close(); the run goes on
                err = e
                self._reg.counter(
                    "checkpoint.async_write_failures_total").inc()
                logger.warning("async checkpoint write to %s failed: %s",
                               self.path, e)
            del snap
            with self._cond:
                self._error = err  # a later success clears it
                self._busy = False
                self._depth.set(self._pending is not None)
                self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every snapshot is written (True) or ``timeout``
        passes (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._busy:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(rem)
        return True

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain and stop the writer; raises :class:`CheckpointError` when
        the final write failed or the writer did not drain."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise CheckpointError(
                self.path, "async checkpoint writer failed to drain",
                hint="the filesystem is stalled; the last snapshot may not "
                     "be durable")
        if self._error is not None:
            raise CheckpointError(
                self.path,
                f"final async checkpoint write failed "
                f"({self._error.__class__.__name__}: {self._error})"
            ) from self._error
