"""The port's CLI: `python -m mfcc_tpu_torch.cli`.

Commands:
  extract     wav files → feature shards (streaming, resumable, data-parallel)
  apply-cmvn  second pass: normalize existing shards with global or
              speaker stats
  convert     npz feature shards → HTK or Kaldi files (resumable)
  serve       on-line extraction over stdin/stdout (docs/SERVE.md)
  plot        4-panel inspection PNGs for wav files (needs matplotlib)
  info        versions, cards, process group, named configs; --self-test

The port of `mfcc_tpu/cli/main.py`, with its commands and flags, except that
`--device {cuda,cpu}` (default cuda) stands where `--backend` stood. On the
card: decode (worker processes into pinned shared-memory slabs, or threads
into pinned rows) → an asynchronous host-to-device copy →
`parallel.sharded_extract_batch` (the front-end kernel, and the feature
tail for mfcc configs) → an asynchronous device-to-host copy into pinned
tensors, waited on by an event per batch → trimmed shard writes with resume
markers on writer threads; global-CMVN moments ride the markers. A config
the port's kernels do not implement, and `--device cuda` without a card,
exit 2 before any shard is written: there is no fallback to the CPU. Shard
names, ids and markers are the JAX package's, so a resume works across the
two packages. `serve` speaks `docs/SERVE.md` over the
`pipeline.MultiStreamExtractor` pool (one front-end launch and at most two
tail launches a poll round), and exits 2 before any event on a config the
kernels refuse or on `--device cuda` without a card.
"""

from __future__ import annotations

import argparse
import glob as globlib
import json
import logging
import pathlib
import sys
import time

import numpy as np

log = logging.getLogger("mfcc_tpu_torch.cli")

# free pinned row buffers the feed keeps a bucket shape (`pipeline.RowPool`)
FEED_BUFFERS = 4


def _expand_files(patterns, aliases: dict | None = None) -> list[str]:
    """Inputs may be wav paths, globs, directories, or manifests:
    `@list.txt` (one path per line; a second whitespace-separated column is
    tolerated Kaldi-style — `<utt-id> <path>` wav.scp lines use the LAST
    field as the path; '#' comments and blank lines skipped).

    aliases, when given, collects path -> manifest utt-id for two-column
    manifest lines, so Kaldi wav.scp + utt2spk pairs compose (speaker
    lookup tries the utt-id first)."""
    out = []
    for p in patterns:
        if p.startswith("@"):
            for line in pathlib.Path(p[1:]).read_text().splitlines():
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                out.append(parts[-1])
                if aliases is not None and len(parts) > 1:
                    aliases[parts[-1]] = parts[0]
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p, recursive=True)))
        elif pathlib.Path(p).is_dir():
            out.extend(sorted(str(q) for q in pathlib.Path(p).rglob("*.wav")))
        else:
            out.append(p)
    # duplicate inputs (repeated manifest lines, overlapping globs) would
    # extract twice: same id twice in one npz shard collapses silently in
    # read_shard, and one ark shard would abort on the duplicate key
    deduped = list(dict.fromkeys(out))
    if len(deduped) != len(out):
        log.warning("%d duplicate input path(s) dropped", len(out) - len(deduped))
    return deduped


def _resolve_config(args):
    """named config + any --set key=value overrides (validated)."""
    from mfcc_tpu_torch import named_config
    from mfcc_tpu_torch.config import config_with_overrides

    cfg = named_config(args.config)
    if getattr(args, "set", None):
        cfg = config_with_overrides(cfg, args.set)
    return cfg


def _refusal(cfg, device: str) -> str | None:
    """Why the port cannot extract cfg on device, or None: the CPU takes
    every config; the card refuses a missing card and a compute dtype other
    than float32."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return ("--device cuda: no CUDA device (torch.cuda.is_available() is "
                    "False); pass --device cpu for the plain chain")
        if cfg.dtype != "float32":
            return f"--device cuda: the kernels compute in float32, not {cfg.dtype}"
    return None


def _to_host(tensors):
    """Start the device-to-host copies of a batch's outputs into pinned host
    tensors; returns (host tensors, the CUDA event recorded after the
    copies). CPU tensors are returned as they are, with no event. The host
    tensors are valid only once the event has completed."""
    import torch

    if all(t.device.type == "cpu" for t in tensors):
        return list(tensors), None
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


def cmd_extract(args) -> int:
    from mfcc_tpu_torch import parallel
    from mfcc_tpu_torch.io import (
        DecodeStats, ShardWriter, SlabPool, shard_files, stream_batches,
        stream_batches_direct, stream_batches_mp, trim_batch,
    )
    from mfcc_tpu_torch.parallel import CmvnAccumulator, data_mesh
    from mfcc_tpu_torch.parallel.mesh import (
        distributed_init, pad_batch_to_shards, process_count, process_index,
    )
    from mfcc_tpu_torch.pipeline import RowPool
    from mfcc_tpu_torch.utils import MetricsLogger
    from mfcc_tpu_torch.utils import trace as trace_mod

    try:
        cfg = _resolve_config(args)
    except (KeyError, ValueError) as e:
        log.error("%s", e.args[0])
        return 2
    reason = _refusal(cfg, args.device)
    if reason:
        log.error("%s", reason)
        return 2
    distributed_init()
    aliases: dict = {}  # path -> manifest utt-id (wav.scp composition)
    files = _expand_files(args.files, aliases)
    if not files:
        log.error("no input files matched")
        return 2
    rank, world = process_index(), process_count()
    files = shard_files(files, rank, world)
    log.info(
        "process %d/%d: %d files, config=%s (%s), device %s",
        rank, world, len(files), args.config, cfg.config_hash(), args.device,
    )

    # local mesh: per-process batch counts differ, so no collective may
    # appear in the per-batch step (see parallel.mesh.data_mesh)
    mesh = data_mesh(local=True, device=args.device)
    n_dev = mesh.shape["data"]
    batch_size = pad_batch_to_shards(args.batch_size, mesh)

    if args.format != "npz" and cfg.cmvn in ("global", "speaker"):
        log.error("--format %s does not support the two-pass %s-CMVN "
                  "rewrite (apply-cmvn operates on npz shards); extract to "
                  "npz and apply-cmvn, or use cmvn=utterance/off",
                  args.format, cfg.cmvn)
        return 2
    writer = ShardWriter(args.output_dir, cfg, compress=args.compress,
                         fmt=args.format)
    metrics = MetricsLogger(
        args.metrics, context={"process": rank, "config": args.config},
    )
    stats = DecodeStats()
    speaker_mode = cfg.cmvn == "speaker"
    want_moments = (
        speaker_mode or cfg.cmvn == "global" or args.cmvn_stats is not None
    )
    if speaker_mode:
        from mfcc_tpu_torch.parallel import (
            SpeakerCmvnAccumulator, read_utt2spk, speaker_of,
        )

        try:
            utt2spk = read_utt2spk(args.utt2spk) if args.utt2spk else None
        except (OSError, ValueError) as e:
            log.error("--utt2spk: %s", e)
            return 2

        def spk_of(uid: str) -> str:
            # manifest utt-ids compose with utt2spk (wav.scp pairs)
            key = aliases.get(uid, uid) if utt2spk else uid
            return speaker_of(key, utt2spk, args.spk_from)

        # validate the whole mapping BEFORE any device work: one typo'd
        # utt2spk entry must not kill the run mid-extraction
        try:
            spk_by_utt = {f: spk_of(f) for f in files}
        except KeyError as e:
            log.error("%s (fix --utt2spk or use --spk-from dir)", e.args[0])
            return 2
        acc = SpeakerCmvnAccumulator(cfg.feat_dim)
    else:
        spk_by_utt = {}
        acc = CmvnAccumulator(cfg.feat_dim) if want_moments else None

    shard_idx = 0
    host = f"h{rank}"
    # pipeline of dispatched batches: shard N-D is written while N computes;
    # depth > 1 hides the device->host copies
    import collections
    import concurrent.futures

    in_flight = collections.deque()  # (shard_name, real_ids, batch, outputs, event)
    # shard writes (npy serialize + disk, GIL-releasing) run on a small
    # pool so the main loop keeps dispatching; bounded so queued feature
    # arrays can't pile up unboundedly
    wpool = concurrent.futures.ThreadPoolExecutor(max_workers=args.write_threads)
    wfuts = collections.deque()

    def fold_speaker(ids, s1, s2, n) -> dict:
        """Fold per-utterance triples into the per-speaker pools; returns
        the marker extra (per-shard pool contributions PLUS the resolved
        utt->spk mapping, so resume can detect a changed mapping)."""
        pools: dict[str, list] = {}
        rec = {}
        for i, uid in enumerate(ids):
            if uid is None:  # failed decode: n=0 row
                continue
            spk = spk_by_utt[uid]
            rec[uid] = spk
            acc.add(spk, s1[i], s2[i], n[i])
            p = pools.setdefault(spk, [np.zeros(cfg.feat_dim),
                                       np.zeros(cfg.feat_dim), 0.0])
            p[0] += s1[i]
            p[1] += s2[i]
            p[2] += float(n[i])
        return {"speaker_moments": {
            s: {"s1": p[0].tolist(), "s2": p[1].tolist(), "n": p[2]}
            for s, p in pools.items()
        }, "spk_by_utt": rec}

    def recover_moments(meta: dict, fold: bool = True) -> bool:
        """Fold a skipped shard's marker moments into acc; False means the
        marker is unusable (pre-moment marker, or — speaker mode — the
        utt->spk mapping changed since it was written) and the shard must
        be recomputed so the pools stay correct. fold=False only answers
        the usability question (the resume planning pass)."""
        if acc is None:
            return True
        extra = meta.get("extra", {})
        if speaker_mode:
            mom = extra.get("speaker_moments")
            rec = extra.get("spk_by_utt")
            if mom is None or rec is None:
                return False
            if any(spk_by_utt.get(uid) != spk for uid, spk in rec.items()):
                return False  # stale mapping: recompute under the new one
            if fold:
                for spk, p in mom.items():
                    acc.add(spk, np.asarray(p["s1"]), np.asarray(p["s2"]),
                            p["n"])
            return True
        mom = extra.get("moments")
        if mom is None:
            return False
        if fold:
            acc.add(np.asarray(mom["s1"]), np.asarray(mom["s2"]), mom["n"])
        return True

    def complete(entry) -> None:
        """Finish one dispatched batch: wait for its device-to-host copies,
        trim, write, count. Runs while the NEXT batch computes on device."""
        shard_name, real_ids, batch, outputs, event = entry
        if event is not None:
            event.synchronize()  # the pinned host tensors hold the batch now
        feat, mask, *moments = (t.numpy() for t in outputs)
        extra = None
        if acc is not None and speaker_mode:
            s1, s2, n = (np.asarray(m, dtype=np.float64) for m in moments)
            extra = fold_speaker(batch.ids, s1, s2, n)
        elif acc is not None:
            s1, s2, n = (np.asarray(m, dtype=np.float64) for m in moments)
            acc.add(s1, s2, n)
            # moments ride the done marker so a resumed run recovers the
            # contribution of every skipped shard
            extra = {
                "moments": {
                    "s1": s1.tolist(), "s2": s2.tolist(), "n": float(n),
                }
            }
        with trace_mod.annotate("shard_write"):
            # pair ids with rows (None ids can appear mid-batch if a decode
            # failed after row assignment in the direct or mp feed)
            trimmed = trim_batch(feat, mask)
            rows = [
                (i, t) for i, t in zip(batch.ids, trimmed) if i is not None
            ]
            while len(wfuts) >= 2 * args.write_threads:
                wfuts.popleft().result()  # backpressure + error propagation
            wfuts.append(wpool.submit(
                writer.write,
                shard_name, [r[0] for r in rows], [r[1] for r in rows],
                extra_meta=extra,
            ))
        metrics.add(
            shards=1,
            utterances=len(real_ids),
            frames=sum(t.shape[0] for t in trimmed),
            audio_seconds=float(batch.lengths.sum())
            / (cfg.input_sample_rate or cfg.sample_rate),
        )
        metrics.set(pad_occupancy=batch.pad_occupancy, devices=n_dev)
        if shard_idx % args.log_every == 0:
            snap = metrics.emit()
            log.info(
                "%d shards, %.0f utt, %.1f audio-s/s",
                snap.get("shards", 0), snap.get("utterances", 0),
                snap.get("audio_s_per_s", 0.0),
            )

    stream_kw = dict(
        batch_size=batch_size, max_len_s=args.max_len_s,
        num_threads=args.threads, stats=stats,
        long_mode="defer" if args.long == "split" else "truncate",
    )
    feed = args.feed
    if feed == "auto":
        # the multi-process feed where the C++ decoder builds (per-file
        # Python runs under the workers' own interpreter locks); both it and
        # the direct feed give byte-identical batches
        from mfcc_tpu_torch.io import wav

        feed = "mp" if wav._native() is not None else "arrays"
        log.info("--feed auto: the %s feed", {"mp": "multi-process", "arrays": "arrays"}[feed])
    # pinned rows for the card: the host-to-device copy is asynchronous
    pin = args.device == "cuda"
    if feed == "direct":
        stream_fn = stream_batches_direct
        stream_kw["dtype"] = args.feed_dtype
        stream_kw["pool"] = RowPool(pin=pin, capacity=FEED_BUFFERS)
    elif feed == "mp":
        stream_fn = stream_batches_mp
        stream_kw["dtype"] = args.feed_dtype
        stream_kw["slabs"] = SlabPool(pin=pin)
    else:
        stream_fn = stream_batches
        if args.feed_dtype != "f32":
            log.warning("--feed-dtype %s requires the direct or mp feed; using f32",
                        args.feed_dtype)
    if args.resume and feed in ("direct", "mp"):
        # header-only planning pass: batch composition depends only on
        # phase-A headers, so a resume decision per shard costs a header
        # scan — files of already-done shards are then never decoded in
        # the real pass
        plan_rows = {"pool": RowPool()} if feed == "direct" else {"slabs": SlabPool()}
        plan_kw = {**stream_kw, **plan_rows, "stats": DecodeStats(),
                   "skip_ids": frozenset(files)}
        done_files: set = set()
        pidx = 0
        for pb in stream_fn(files, cfg, **plan_kw):
            pname = f"{host}-{pidx:06d}"
            pidx += 1
            preal = [i for i in pb.ids if i is not None]
            if writer.is_done(pname, preal) and recover_moments(
                writer.marker_meta(pname) or {}, fold=False
            ):
                done_files.update(preal)
            pb.release()
        if done_files:
            log.info("resume plan: %d of %d files already extracted "
                     "(decode skipped)", len(done_files), len(files))
        stream_kw["skip_ids"] = frozenset(done_files)

    with_moments = "per_utterance" if speaker_mode else want_moments
    with trace_mod.trace(args.profile_dir):
        for batch in stream_fn(files, cfg, **stream_kw):
            shard_name = f"{host}-{shard_idx:06d}"
            shard_idx += 1
            real_ids = [i for i in batch.ids if i is not None]
            planned_skip = bool(stream_kw.get("skip_ids")) and any(
                i in stream_kw["skip_ids"] for i in real_ids
            )
            if args.resume and writer.is_done(shard_name, real_ids):
                if recover_moments(writer.marker_meta(shard_name) or {}):
                    metrics.add(shards_skipped=1, utterances=len(real_ids))
                    batch.release()
                    continue
                log.info("shard %s lacks usable moments (pre-moment marker "
                         "or changed speaker mapping); recomputing",
                         shard_name)
            if planned_skip:
                # the planning pass skipped this batch's decode, but the
                # resume check now disagrees: the corpus changed between
                # passes — computing from undecoded rows would write
                # garbage, so fail loudly
                raise RuntimeError(
                    f"corpus changed during resume planning (shard "
                    f"{shard_name} no longer matches its marker); rerun"
                )
            with trace_mod.annotate("dispatch"):
                t_disp = time.perf_counter()
                feat, mask, moments = parallel.sharded_extract_batch(
                    batch.audio, batch.lengths, cfg, mesh,
                    with_moments=with_moments, copy_events=batch.copy_events,
                )
                # the pool refills the rows only once their copy completed
                batch.release()
                outputs, event = _to_host([feat, mask, *(moments or ())])
                # host-side dispatch wall (H2D enqueue + launches);
                # decode_queue_depth: jobs in flight when this batch flushed
                metrics.set(
                    dispatch_ms=round((time.perf_counter() - t_disp) * 1e3, 2),
                    decode_queue_depth=stats.queue_depth,
                )
            in_flight.append((shard_name, real_ids, batch, outputs, event))
            while len(in_flight) >= max(1, args.pipeline_depth):
                complete(in_flight.popleft())
        while in_flight:
            complete(in_flight.popleft())
        while wfuts:
            wfuts.popleft().result()
        wpool.shutdown(wait=True)

        # over-long utterances: split/stitch extraction, one shard per file
        # (frame-exact vs the per-utterance loop — pipeline.longform)
        from mfcc_tpu_torch.io import read_wav
        from mfcc_tpu_torch.pipeline import extract_long, long_moments

        expect_sr = cfg.input_sample_rate or cfg.sample_rate
        for li, path in enumerate(stats.long_paths):
            shard_name = f"{host}-long-{li:06d}"
            if args.resume and writer.is_done(shard_name, [path]):
                if recover_moments(writer.marker_meta(shard_name) or {}):
                    metrics.add(shards_skipped=1, utterances=1)
                    continue
                log.info("shard %s lacks usable moments (pre-moment marker "
                         "or changed speaker mapping); recomputing",
                         shard_name)
            try:
                sr, samples = read_wav(path)
            except (OSError, ValueError) as e:
                log.warning("skipping %s: %s", path, e)
                metrics.add(decode_errors=1)
                stats.errors += 1
                continue
            if sr != expect_sr:
                stats.wrong_rate += 1
                continue
            with trace_mod.annotate("long_extract"):
                feat = extract_long(
                    samples, cfg, device=mesh.devices[0], seg_len_s=args.max_len_s
                ).cpu().numpy()
            extra = None
            if acc is not None and speaker_mode:
                s1, s2, n = long_moments(feat)
                extra = fold_speaker(
                    [path], s1[None], s2[None], np.asarray([n])
                )
            elif acc is not None:
                s1, s2, n = long_moments(feat)
                acc.add(s1, s2, n)
                extra = {"moments": {
                    "s1": s1.tolist(), "s2": s2.tolist(), "n": float(n),
                }}
            writer.write(shard_name, [path], [feat], extra_meta=extra)
            stats.decoded += 1
            stats.audio_seconds += samples.shape[0] / sr
            metrics.add(
                shards=1, utterances=1, frames=feat.shape[0],
                audio_seconds=samples.shape[0] / sr,
            )

    metrics.set(
        decode_errors=stats.errors, wrong_rate=stats.wrong_rate,
        truncated=stats.truncated, long_split=stats.long_deferred,
    )
    metrics.emit("done")
    if acc is not None and acc.n > 0:
        stats_path = args.cmvn_stats or str(
            pathlib.Path(args.output_dir) / f"cmvn_moments_{host}.npz"
        )
        acc.save(stats_path)
        log.info("CMVN moments (n=%.0f frames%s) -> %s", acc.n,
                 f", {len(acc.pools)} speakers" if speaker_mode else "",
                 stats_path)
        if cfg.cmvn in ("global", "speaker"):
            log.info(
                "run `python -m mfcc_tpu_torch.cli apply-cmvn %s --stats %s "
                "--config %s%s` to normalize (merging per-process moment "
                "files first if multi-process)",
                args.output_dir, stats_path, args.config,
                " --utt2spk ..." if speaker_mode and args.utt2spk else "",
            )
    log.info(
        "done: %d utterances (%d long-split), %d decode errors, "
        "%d wrong-rate, %d truncated",
        stats.decoded, stats.long_deferred, stats.errors, stats.wrong_rate,
        stats.truncated,
    )
    return 0


def _normalize_shard(spath_str: str, resolve, var_norm: bool,
                     stats_fp: str, force: bool = False,
                     compress: str = "none") -> str:
    """Normalize one shard in place, idempotently. Returns the outcome:
    "normalized" | "skipped" (already carries this stats fingerprint) |
    "mismatch" (normalized with DIFFERENT stats — re-applying would stack
    two normalizations) | "not_features" (e.g. a moments checkpoint).

    resolve(utt_id) -> (mean, std): constant for global CMVN, the
    utterance's speaker pool for speaker CMVN. The applied fingerprint is
    stored INSIDE the shard npz (key cmvn_fp) so a crash mid-corpus
    leaves per-shard truth, not one directory-level marker written only
    at the end: the rerun skips exactly the shards already done."""
    spath = pathlib.Path(spath_str)
    with np.load(spath, allow_pickle=False) as z:
        if "features" not in z.files:
            return "not_features"
        if "cmvn_fp" in z.files and not force:
            return "skipped" if str(z["cmvn_fp"]) == stats_fp else "mismatch"
        feats, offsets, ids = z["features"], z["offsets"], z["ids"]
    for i in range(len(ids)):
        mean, std = resolve(str(ids[i]))
        seg = feats[offsets[i] : offsets[i + 1]]
        seg -= mean
        if var_norm:
            seg /= std
    tmp = spath.with_name(spath.stem + ".tmp.npz")
    save = np.savez_compressed if compress == "zlib" else np.savez
    save(tmp, features=feats.astype(np.float32),
         offsets=offsets, ids=ids,
         cmvn_fp=np.array(stats_fp))
    tmp.rename(spath)  # atomic: a kill leaves either old or new, never half
    return "normalized"


def cmd_apply_cmvn(args) -> int:
    """Pass 2 of global CMVN: normalize every shard in place with the
    finalized corpus stats (merged over all moment files given).

    Idempotency is per-shard: each normalized npz records the stats
    fingerprint it was normalized with (see _normalize_shard), so a rerun
    after a mid-corpus crash finishes exactly the remaining shards instead
    of double-normalizing the done ones. Shards normalized with different
    stats abort the run (use --force only after regenerating shards).
    Shards are processed by a thread pool: the per-shard work is zlib
    inflate → numpy arithmetic → zlib deflate, all GIL-releasing, so
    threads genuinely parallelize it — without the __main__ re-import
    hazards spawned process pools impose on library callers."""
    import concurrent.futures
    import hashlib
    import os

    from mfcc_tpu_torch.parallel import (
        CmvnAccumulator, SpeakerCmvnAccumulator, is_speaker_stats,
        read_utt2spk, speaker_of,
    )

    try:
        cfg = _resolve_config(args)
    except (KeyError, ValueError) as e:
        log.error("%s", e.args[0])
        return 2
    kinds = {p: is_speaker_stats(p) for p in args.stats}
    if len(set(kinds.values())) > 1:
        log.error("mixed stats files: %s are per-speaker, %s are global — "
                  "merge only one kind",
                  [p for p, k in kinds.items() if k],
                  [p for p, k in kinds.items() if not k])
        return 2
    speaker = kinds[args.stats[0]]
    h = hashlib.sha256()
    if speaker:
        sacc = SpeakerCmvnAccumulator(cfg.feat_dim)
        for mpath in args.stats:
            sacc.merge(SpeakerCmvnAccumulator.load(mpath))
        by_spk = {
            s: (st.mean.astype(np.float32), st.std.astype(np.float32))
            for s, st in sacc.finalize(cfg).items()
        }
        try:
            utt2spk = read_utt2spk(args.utt2spk) if args.utt2spk else None
        except (OSError, ValueError) as e:
            log.error("--utt2spk: %s", e)
            return 2

        def resolve(uid: str):
            spk = speaker_of(uid, utt2spk, args.spk_from)
            try:
                return by_spk[spk]
            except KeyError:
                raise KeyError(
                    f"speaker {spk!r} (utterance {uid!r}) has no pooled "
                    "stats — wrong --utt2spk/--spk-from, or the stats came "
                    "from a different corpus?"
                ) from None

        # the normalized bytes depend on the pools AND the mapping; hash
        # the PARSED mapping so reordering/whitespace/comments in a
        # regenerated utt2spk don't spuriously invalidate done shards
        for s in sorted(by_spk):
            h.update(s.encode())
            h.update(by_spk[s][0].tobytes())
            h.update(by_spk[s][1].tobytes())
        if utt2spk:
            for k in sorted(utt2spk):
                h.update(f"{k}\0{utt2spk[k]}\0".encode())
        else:
            h.update(f"spk-from:{args.spk_from}".encode())
        n_frames = sacc.n
    else:
        acc = CmvnAccumulator(cfg.feat_dim)
        for mpath in args.stats:
            acc.merge(CmvnAccumulator.load(mpath))
        stats = acc.finalize(cfg)
        mean = stats.mean.astype(np.float32)
        std = stats.std.astype(np.float32)
        resolve = lambda uid: (mean, std)  # noqa: E731
        h.update(mean.tobytes())
        h.update(std.tobytes())
        n_frames = stats.n
    stats_fp = h.hexdigest()[:16]

    shard_dir = pathlib.Path(args.shard_dir)
    paths = []
    for spath in sorted(shard_dir.glob("*.npz")):
        if spath.name.endswith(".tmp.npz"):  # leftover from a crash
            spath.unlink()
            continue
        paths.append(str(spath))

    counts = {"normalized": 0, "skipped": 0, "mismatch": 0, "not_features": 0}
    mismatched = []
    workers = args.jobs or min(len(paths) or 1, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        futs = {
            pool.submit(_normalize_shard, p, resolve, cfg.cmvn_var_norm,
                        stats_fp, args.force, args.compress): p
            for p in paths
        }
        for fut in concurrent.futures.as_completed(futs):
            try:
                outcome = fut.result()
            except KeyError as e:
                log.error("%s", e.args[0])
                return 1
            counts[outcome] += 1
            if outcome == "mismatch":
                mismatched.append(futs[fut])
    if mismatched:
        log.error(
            "%d shard(s) already normalized with DIFFERENT stats (e.g. %s); "
            "refusing to stack normalizations — regenerate those shards",
            len(mismatched), mismatched[0],
        )
        return 1
    marker = shard_dir / "done" / "cmvn_applied.json"
    marker.parent.mkdir(parents=True, exist_ok=True)
    marker.write_text(json.dumps({
        "stats_fingerprint": stats_fp,
        "n_frames": n_frames,
        "shards": counts["normalized"] + counts["skipped"],
        "applied_at": time.time(),
    }))
    log.info(
        "normalized %d shards (%d already done) with corpus stats "
        "(n=%.0f frames, %d workers)",
        counts["normalized"], counts["skipped"], n_frames, workers,
    )
    return 0


WIRE_HEADER_CAP = 1 << 20  # a framed header's bytes, in and out (docs/SERVE.md)
WIRE_PAYLOAD_CAP = 1 << 30  # a framed payload's bytes, in
DRAIN_EVERY = 256  # request lines between drains under saturating input
IDLE_TICK_S = 0.2  # a drain after this long with no request


def cmd_convert(args) -> int:
    """Convert npz feature shards to HTK or Kaldi files: the last step of
    the two-pass global-CMVN path (extract to npz → apply-cmvn → convert)
    and an exporter of existing corpora. Resumable by the extract's marker
    scheme (one marker a source shard in the output directory); a shard
    whose feature dimension is not the config's exits 2."""
    import concurrent.futures

    from mfcc_tpu_torch.io import ShardWriter
    from mfcc_tpu_torch.io.writer import iter_feature_shards

    try:
        cfg = _resolve_config(args)
    except (KeyError, ValueError) as e:
        log.error("%s", e.args[0])
        return 2
    shard_dir = pathlib.Path(args.shard_dir)
    paths = iter_feature_shards(shard_dir)
    if not paths:
        log.error("no feature shards (*.npz) in %s", shard_dir)
        return 2
    writer = ShardWriter(args.output_dir, cfg, fmt=args.to)

    def convert_one(spath: pathlib.Path) -> tuple[str, int]:
        name = spath.stem
        with np.load(spath, allow_pickle=False) as z:
            # npz members load lazily: the resume check reads only the ids,
            # so a finished rerun reads no feature bytes
            ids = [str(i) for i in z["ids"]]
            if writer.is_done(name, ids):
                return "skipped", len(ids)
            feats, offsets = z["features"], z["offsets"]
        if feats.shape[1] != cfg.feat_dim:
            raise ValueError(
                f"{spath.name}: feat dim {feats.shape[1]} != config "
                f"{args.config}'s {cfg.feat_dim} — wrong --config/--set?"
            )
        writer.write(name, ids, [feats[offsets[i] : offsets[i + 1]] for i in range(len(ids))])
        return "converted", len(ids)

    counts = {"converted": 0, "skipped": 0}
    utts = 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=args.jobs) as pool:
        try:
            for outcome, n in pool.map(convert_one, paths):
                counts[outcome] += 1
                utts += n
        except (ValueError, KeyError, OSError) as e:
            log.error("%s", e)
            return 2
    log.info("%d shards -> %s (%d already done), %d utterances, format=%s",
             counts["converted"], args.output_dir, counts["skipped"], utts, args.to)
    return 0


def cmd_plot(args) -> int:
    """4-panel waveform / spectrogram / filterbank / features PNG a wav
    (`mfcc_tpu_torch.viz`), the chain run on --device. Exits 2 without
    matplotlib, on a config the port refuses and on --device cuda without
    a card; 1 when a file could not be read."""
    from mfcc_tpu_torch.io import read_wav

    try:
        from mfcc_tpu_torch import viz

        plt = viz._plt()
    except ImportError as e:
        log.error("plot: %s (pip install matplotlib)", e)
        return 2
    try:
        cfg = _resolve_config(args)
    except (KeyError, ValueError) as e:
        log.error("%s", e.args[0])
        return 2
    reason = _refusal(cfg, args.device)
    if reason:
        log.error("%s", reason)
        return 2
    files = _expand_files(args.files)
    if not files:
        log.error("no input files matched")
        return 2
    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    expect_sr = cfg.input_sample_rate or cfg.sample_rate
    failed = 0
    for path in files:
        try:
            sr, samples = read_wav(path)
        except (OSError, ValueError) as e:
            log.warning("skipping %s: %s", path, e)
            failed += 1
            continue
        if sr != expect_sr:
            log.warning("skipping %s: sample rate %d != config's %d", path, sr, expect_sr)
            failed += 1
            continue
        out = out_dir / (pathlib.Path(path).stem + ".png")
        plt.close(viz.plot_all(samples, cfg, out_path=out, device=args.device))
        log.info("%s -> %s", path, out)
    return 0 if failed == 0 else 1


# the self-test's gate against the float64 oracle: the reference's (the
# documented fp32 floor of lifted cepstra, 1.34e-3, on pathological signals)
SELF_TEST_GATE = 2e-3


def _cards() -> list[str]:
    """`name, power limit` of each card as nvidia-smi gives them; torch's
    device names when nvidia-smi cannot be run."""
    import subprocess

    import torch

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return [line.strip() for line in res.stdout.strip().splitlines()]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return [f"{torch.cuda.get_device_name(i)}, power limit not read"
            for i in range(torch.cuda.device_count())]


def cmd_info(args) -> int:
    """Versions, cards, the process group and every named config with its
    hash; --self-test runs classic13_deltas and logmel80 through the port on
    --device and on the CPU against the float64 oracle (`ops/
    reference_numpy.py`) at the reference's gate. --self-test on cuda
    without a card exits 2."""
    import torch
    import torch.distributed as dist

    from mfcc_tpu_torch import NAMED_CONFIGS

    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"cuda available={torch.cuda.is_available()}")
    if torch.cuda.is_available():
        for i, card in enumerate(_cards()):
            print(f"card {i}: {card}")
    else:
        print("cards: none visible")
    if dist.is_available() and dist.is_initialized():
        print(f"process {dist.get_rank()}/{dist.get_world_size()} ({dist.get_backend()})")
    else:
        print("process 0/1 (no process group)")
    print("named configs:")
    for name, cfg in NAMED_CONFIGS.items():
        print(
            f"  {name:24s} sr={cfg.sample_rate} in_sr={cfg.input_sample_rate or '-'} "
            f"mels={cfg.n_mels} feat={cfg.features}:{cfg.feat_dim} cmvn={cfg.cmvn} "
            f"hash={cfg.config_hash()}"
        )
    if not args.self_test:
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("--self-test --device cuda: no CUDA device (torch.cuda.is_available() is "
                  "False); pass --device cpu")
        return 2

    # a deployment smoke: the port on this machine's card and on the CPU
    # against the float64 oracle
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.ops import reference_numpy as ref

    x = np.random.default_rng(0).standard_normal(16000) * 3000.0
    failures = 0
    for cname in ("classic13_deltas", "logmel80"):
        cfg = NAMED_CONFIGS[cname]
        want = ref.extract(x, cfg)
        for device in dict.fromkeys((args.device, "cpu")):
            t0 = time.perf_counter()
            got = chain.extract_single(x, cfg, device=device).cpu().numpy()
            dt = (time.perf_counter() - t0) * 1e3
            err = float(np.abs(got.astype(np.float64) - want).max()) if got.shape == want.shape else float("inf")
            ok = err < SELF_TEST_GATE
            failures += not ok
            print(f"self-test {cname:18s} {device:5s} max|err|={err:.2e} "
                  f"{'ok' if ok else 'FAIL'} ({dt:.0f} ms)")
    print("self-test:", "PASS" if failures == 0 else f"{failures} FAILURES")
    return 0 if failures == 0 else 1


def chunk_metas(metas: list[dict], cap: int) -> list[list[dict]]:
    """Split a frames_batch event's stream metas into runs whose header
    ({"event": "frames_batch", "streams": [...]}) stays under cap bytes of
    JSON, so no outbound header reaches the reader's cap."""
    room = cap - len(json.dumps({"event": "frames_batch", "streams": []}))
    runs, run, size = [], [], 0
    for m in metas:
        n = len(json.dumps(m)) + 2  # ", " between entries
        if run and size + n > room:
            runs.append(run)
            run, size = [], 0
        run.append(m)
        size += n
    if run:
        runs.append(run)
    return runs


def _serve_moments(args, cfg):
    """(s1, s2, n) for the pool from --cmvn-stats (global, or --speaker's
    pool of speaker stats), None without; raises ValueError with the
    refusal."""
    if not args.cmvn_stats:
        return None
    from mfcc_tpu_torch.parallel import (
        CmvnAccumulator, SpeakerCmvnAccumulator, is_speaker_stats,
    )

    if is_speaker_stats(args.cmvn_stats[0]):
        sacc = SpeakerCmvnAccumulator(cfg.feat_dim)
        for mpath in args.cmvn_stats:
            sacc.merge(SpeakerCmvnAccumulator.load(mpath))
        if not args.speaker or args.speaker not in sacc.pools:
            raise ValueError(
                "speaker-CMVN stats need --speaker to pick this server's pool; "
                f"available: {sorted(sacc.pools)}"
            )
        spool = sacc.pools[args.speaker]
        return spool.s1, spool.s2, spool.n
    acc = CmvnAccumulator(cfg.feat_dim)
    for mpath in args.cmvn_stats:
        acc.merge(CmvnAccumulator.load(mpath))
    return acc.s1, acc.s2, acc.n


def _read_exact(src, n: int) -> bytes:
    """Up to n bytes: b"" at EOF before any byte, fewer at EOF mid-field."""
    buf = b""
    while len(buf) < n:
        chunk = src.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def _binary_reader(src, put) -> None:
    """The framed wire's reader: puts ("req", header, payload), ("bad_req",
    msg) for a bad header inside an intact frame, or ("bad", msg) for a
    framing error (the byte stream has no resync point), then None at EOF."""
    import struct

    while True:
        hl = _read_exact(src, 4)
        if not hl:
            break  # a clean EOF at a frame boundary
        if len(hl) < 4:
            put(("bad", "truncated message (length prefix)"))
            break
        (hlen,) = struct.unpack("<I", hl)
        if hlen > WIRE_HEADER_CAP:
            put(("bad", f"header length {hlen} > 1 MiB"))
            break
        head = _read_exact(src, hlen)
        pl = _read_exact(src, 4) if len(head) == hlen else b""
        if len(pl) < 4:
            put(("bad", "truncated message"))
            break
        (plen,) = struct.unpack("<I", pl)
        if plen > WIRE_PAYLOAD_CAP:
            put(("bad", f"payload length {plen} > 1 GiB"))
            break
        payload = _read_exact(src, plen) if plen else b""
        if len(payload) < plen:
            put(("bad", "truncated payload"))
            break
        try:
            req = json.loads(head.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            put(("bad_req", f"bad header JSON: {e}"))
            continue
        put(("req", req, payload))
    put(None)


def cmd_serve(args) -> int:
    """On-line serving: requests on stdin, events on stdout, as
    docs/SERVE.md states them (the reference's protocol), driving the
    `MultiStreamExtractor` pool on the card. One process serves up to
    --streams sessions with one front-end launch and at most two tail
    launches a poll round, whatever the number of sessions.

    Requests (one JSON object per line, or framed with --wire binary):
      {"op":"open"[, "id":<client tag>]}       -> {"event":"opened","sid":N}
      {"op":"push","sid":N,"pcm16":"<b64>"}    little-endian int16 samples
      {"op":"push","sid":N,"samples":[...]}    float samples (int16 range)
      {"op":"end","sid":N}      audio complete; tail frames follow
      {"op":"close","sid":N}    abandon (no tail extraction)
      {"op":"poll"}             force a poll round
      {"op":"stats"}            -> {"event":"stats", ...pool counters}
    Events: frames (sid, n, dim and the <f4 row-major payload: b64 "data",
    "frames" lists with --emit list, or the framed payload), frames_batch
    (--emit b64-batched: one a poll round, its stream metas split so no
    header reaches 1 MiB), done, stats, error.

    Drains run when the request queue empties (a burst's end), on "poll",
    on a 0.2 s idle tick, and at latest every 256 lines. A push that trips
    the pool's per-session buffer cap (`BufferFullError`) drains and
    retries once. EOF, SIGTERM and SIGINT flush: open streams are ended,
    their tails drained, a final stats event emitted. --wire binary frames
    every message as u32 header_len | JSON header | u32 payload_len |
    payload (push audio raw <i2, frames raw <f4); a framing error flushes
    like EOF. stdin is read on a thread that touches no CUDA; the signal
    handlers only set a flag, from the main thread."""
    import base64
    import queue
    import signal
    import struct
    import threading

    from mfcc_tpu_torch.pipeline import BufferFullError, MultiStreamExtractor
    from mfcc_tpu_torch.utils import MetricsLogger

    try:
        cfg = _resolve_config(args)
    except (KeyError, ValueError) as e:
        log.error("%s", e.args[0])
        return 2
    reason = _refusal(cfg, args.device)
    if reason:
        log.error("%s", reason)
        return 2
    wire = args.wire
    if wire == "binary" and args.emit == "list":
        # list mode puts the whole frames list in the JSON header, which
        # can exceed the framed-header cap after one long tail drain
        log.error("--emit list is a jsonl-wire debug mode; use b64/"
                  "b64-batched with --wire binary")
        return 2
    try:
        moments = _serve_moments(args, cfg)
        pool = MultiStreamExtractor(
            cfg, n_streams=args.streams, frames_per_block=args.frames_per_block,
            cmvn_moments=moments, device=args.device,
        )
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 2

    fin, fout = sys.stdin, sys.stdout
    metrics = MetricsLogger(args.metrics, context={"config": args.config})
    t0 = time.perf_counter()
    audio_s = 0.0
    sr_in = cfg.input_sample_rate or cfg.sample_rate
    client_gone = False
    fout_b = getattr(fout, "buffer", fout)

    def emit(obj, payload: bytes = b"") -> None:
        # a consumer that closed its read end must not crash the server
        # mid-stream: flag it, so the loop winds down and metrics still land
        nonlocal client_gone
        if client_gone:
            return
        try:
            if wire == "binary":
                head = json.dumps(obj).encode()
                fout_b.write(struct.pack("<I", len(head)) + head
                             + struct.pack("<I", len(payload)) + payload)
                fout_b.flush()
            else:
                fout.write(json.dumps(obj) + "\n")
                fout.flush()
        except (BrokenPipeError, OSError):
            client_gone = True

    def tile(feat) -> bytes:
        return np.ascontiguousarray(feat, dtype="<f4").tobytes()

    def drain() -> None:
        polled = pool.poll()
        if args.emit == "b64-batched":
            # one frames_batch event a poll round (split only where its
            # metas would reach the header cap): the streams' [n_i, dim] f32
            # tiles concatenated row-major in listed order
            ready = [(sid, feat) for sid, feat in polled.items() if feat.shape[0]]
            metas = [{"sid": sid, "n": int(f.shape[0]), "dim": int(f.shape[1])} for sid, f in ready]
            tiles = {sid: tile(f) for sid, f in ready}
            for run in chunk_metas(metas, WIRE_HEADER_CAP):
                payload = b"".join(tiles[m["sid"]] for m in run)
                if wire == "binary":
                    emit({"event": "frames_batch", "streams": run}, payload=payload)
                else:
                    emit({"event": "frames_batch", "streams": run,
                          "data": base64.b64encode(payload).decode("ascii")})
            for sid in polled:
                if pool.done(sid):
                    emit({"event": "done", "sid": sid})
            return
        for sid, feat in polled.items():
            if feat.shape[0]:
                head = {"event": "frames", "sid": sid, "n": int(feat.shape[0]),
                        "dim": int(feat.shape[1])}
                if args.emit == "list":
                    emit({**head, "frames": [[round(float(v), 6) for v in row] for row in feat]})
                elif wire == "binary":
                    emit(head, payload=tile(feat))
                else:
                    emit({**head, "data": base64.b64encode(tile(feat)).decode("ascii")})
            if pool.done(sid):
                emit({"event": "done", "sid": sid})

    # SIGTERM (process managers' stop signal) and SIGINT flush like EOF; the
    # handlers only set a flag, and stdin is read on a daemon thread, so the
    # main loop observes the flag instead of blocking in a read
    shutdown = threading.Event()
    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, lambda *_: shutdown.set())
        except ValueError:  # not the main thread (library or test use): skip
            pass
    lines_q: queue.Queue = queue.Queue()

    def read_lines() -> None:
        for raw in fin:
            lines_q.put(raw)
        lines_q.put(None)  # EOF

    if wire == "binary":
        reader = threading.Thread(target=_binary_reader,
                                  args=(getattr(fin, "buffer", fin), lines_q.put), daemon=True)
    else:
        reader = threading.Thread(target=read_lines, daemon=True)
    reader.start()

    lines_since_drain = 0
    try:
        while not shutdown.is_set():
            try:
                line = lines_q.get(timeout=IDLE_TICK_S)
            except queue.Empty:
                drain()
                lines_since_drain = 0
                continue
            if line is None:
                break  # EOF
            payload, req = b"", None
            if isinstance(line, tuple):  # the binary reader's items
                if line[0] == "bad":
                    emit({"event": "error", "msg": f"wire framing error: {line[1]}; flushing"})
                    break  # a desynced byte stream: flush like EOF
                if line[0] == "bad_req":
                    emit({"event": "error", "msg": line[1]})
                    continue
                _, req, payload = line
            else:
                line = line.strip()
                if not line:
                    continue
            force_drain = False
            try:
                framed = req is not None
                req = json.loads(line) if req is None else req
                op = req["op"]
                if op == "open":
                    sid = pool.open()
                    emit({"event": "opened", "sid": sid, **({"id": req["id"]} if "id" in req else {})})
                elif op == "push":
                    if framed and "pcm16" not in req and "samples" not in req:
                        # the binary wire: raw little-endian int16 PCM, possibly
                        # empty (a 0-sample no-op, as pcm16="" on jsonl)
                        x = np.frombuffer(payload, dtype="<i2").astype(np.float32)
                    elif "pcm16" in req:
                        x = np.frombuffer(base64.b64decode(req["pcm16"]), dtype="<i2").astype(np.float32)
                    else:
                        x = np.asarray(req["samples"], dtype=np.float32).reshape(-1)
                    try:
                        pool.push(req["sid"], x)
                    except BufferFullError:
                        # backpressure only: drain (frees buffered blocks) and
                        # retry once, so the chunk's audio is not dropped
                        drain()
                        lines_since_drain = 0
                        pool.push(req["sid"], x)
                    audio_s += x.size / sr_in
                elif op == "end":
                    pool.end(req["sid"])
                elif op == "close":
                    pool.close(req["sid"])
                    emit({"event": "done", "sid": req["sid"]})
                elif op == "poll":
                    force_drain = True
                elif op == "stats":
                    emit({"event": "stats", "active": pool.n_active, **pool.stats})
                else:
                    emit({"event": "error", "msg": f"unknown op {op!r}"})
            except (KeyError, IndexError, ValueError, RuntimeError, TypeError) as e:
                emit({"event": "error", "msg": f"{type(e).__name__}: {e}"})
            lines_since_drain += 1
            if force_drain or lines_since_drain >= DRAIN_EVERY or lines_q.empty():
                drain()
                lines_since_drain = 0
            if client_gone:
                break
    finally:
        if shutdown.is_set():
            log.info("shutdown signal: flushing open streams")
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    # EOF or shutdown: end the open streams and drain their tails
    pool.end_all()
    while pool.n_active:
        drain()
    wall = time.perf_counter() - t0
    metrics.set(audio_seconds=round(audio_s, 3), wall_s=round(wall, 3),
                rtf=round(audio_s / wall, 2) if wall > 0 else 0.0, **pool.stats)
    snap = metrics.emit("done")
    emit({"event": "stats", "active": 0, **{k: snap[k] for k in pool.stats},
          "audio_seconds": snap["audio_seconds"], "wall_s": snap["wall_s"], "rtf": snap["rtf"]})
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mfcc_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    set_help = ("override a FrontendConfig field on top of --config, e.g. "
                "--set window=povey --set n_mels=40 (repeatable; the "
                "config hash and resume markers track the overridden "
                "config)")

    e = sub.add_parser("extract", help="extract features from wav files")
    e.add_argument("files", nargs="+",
                   help="wav paths, globs, directories, or @list.txt "
                        "manifests (one path per line; Kaldi wav.scp "
                        "'<utt> <path>' lines accepted)")
    e.add_argument("--config", default="classic13")
    e.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help=set_help)
    e.add_argument("--output-dir", "-o", required=True)
    e.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA kernels on the card, and "
                        "exit 2 without one; cpu: the plain torch chain")
    e.add_argument("--batch-size", type=int, default=64)
    e.add_argument("--max-len-s", type=float, default=10.0,
                   help="largest batch bucket; longer files follow --long")
    e.add_argument("--long", choices=["split", "truncate"], default="split",
                   help="over-long files: split = frame-exact segment/stitch "
                        "extraction (default); truncate = clip to the top "
                        "bucket")
    e.add_argument("--threads", type=int, default=4)
    e.add_argument("--pipeline-depth", type=int, default=3,
                   help="dispatched batches kept in flight before the "
                        "oldest is written (hides the device->host copies)")
    e.add_argument("--feed", choices=["auto", "mp", "direct", "arrays"],
                   default="auto",
                   help="mp: worker processes decode into shared-memory "
                        "slabs (pinned once for the card); direct: threaded "
                        "decode into (pinned) batch rows; arrays: simple "
                        "threaded path; auto: mp where the C++ wav decoder "
                        "builds, else arrays")
    e.add_argument("--feed-dtype", choices=["f32", "i16"], default="i16",
                   help="i16 (default): half-bandwidth host rows, cast on "
                        "device — PCM16 sources are bit-exact, other widths "
                        "quantize at ±0.5 LSB of the int16 scale; f32: "
                        "full-precision rows for non-PCM16 corpora")
    e.add_argument("--compress", choices=["none", "zlib"], default="none",
                   help="shard npz compression (default none: fp32 features "
                        "deflate ~1.1x and zlib would gate the writer)")
    e.add_argument("--format", choices=["npz", "htk", "kaldi"], default="npz",
                   help="npz: ragged shard files (native); htk: one "
                        "big-endian HTK parameter file per utterance "
                        "(io/htk.py); kaldi: one binary .ark + .scp pair "
                        "per shard (io/kaldi.py)")
    e.add_argument("--write-threads", type=int, default=2,
                   help="async shard-writer threads")
    e.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True)
    e.add_argument("--cmvn-stats", default=None,
                   help="path for the global/speaker CMVN moment checkpoint")
    e.add_argument("--utt2spk", default=None,
                   help="Kaldi utt2spk file ('<utt> <spk>' lines) for "
                        "cmvn=speaker; default derives the speaker from "
                        "the wav's parent directory (--spk-from dir)")
    e.add_argument("--spk-from", choices=["dir"], default="dir",
                   help="speaker derivation when no --utt2spk is given")
    e.add_argument("--metrics", default=None, help="JSON-lines metrics file")
    e.add_argument("--log-every", type=int, default=10)
    e.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    e.set_defaults(fn=cmd_extract)

    a = sub.add_parser("apply-cmvn", help="normalize shards with global stats")
    a.add_argument("shard_dir")
    a.add_argument("--stats", nargs="+", required=True,
                   help="one or more cmvn moment .npz files (merged)")
    a.add_argument("--config", default="classic13")
    a.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help=set_help)
    a.add_argument("--utt2spk", default=None,
                   help="Kaldi utt2spk file for speaker-CMVN stats "
                        "(must map the same way as the extract pass)")
    a.add_argument("--spk-from", choices=["dir"], default="dir",
                   help="speaker derivation when no --utt2spk is given")
    a.add_argument("--force", action="store_true",
                   help="re-normalize even shards already carrying a stats "
                        "fingerprint (stacks normalizations — only after "
                        "regenerating shards)")
    a.add_argument("--jobs", type=int, default=None,
                   help="worker threads (default: min(shards, cpus))")
    a.add_argument("--compress", choices=["none", "zlib"], default="none",
                   help="compression for rewritten shards")
    a.set_defaults(fn=cmd_apply_cmvn)

    c = sub.add_parser("convert", help="convert npz feature shards to HTK/Kaldi files")
    c.add_argument("shard_dir", help="directory of extracted npz shards")
    c.add_argument("--output-dir", "-o", required=True)
    c.add_argument("--to", choices=["htk", "kaldi"], required=True)
    c.add_argument("--config", default="classic13",
                   help="the config the shards were extracted with (HTK "
                        "parmKind/hop and a feat-dim sanity check)")
    c.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help=set_help)
    c.add_argument("--jobs", type=int, default=4)
    c.set_defaults(fn=cmd_convert)

    s = sub.add_parser("serve", help="on-line serving over stdin/stdout (docs/SERVE.md)")
    s.add_argument("--config", default="classic13")
    s.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help=set_help)
    s.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA kernels on the card, and "
                        "exit 2 without one; cpu: the kernels' plain versions")
    s.add_argument("--streams", type=int, default=16,
                   help="max concurrent sessions (pool slots)")
    s.add_argument("--frames-per-block", type=int, default=16,
                   help="frames per device block (latency/throughput knob)")
    s.add_argument("--cmvn-stats", nargs="+", default=None,
                   help="cmvn moment .npz files (required for global/"
                        "speaker-CMVN configs; merged)")
    s.add_argument("--speaker", default=None,
                   help="with speaker-CMVN stats: the pool to normalize "
                        "this server's sessions with")
    s.add_argument("--wire", choices=["jsonl", "binary"], default="jsonl",
                   help="transport framing: jsonl (one JSON object per "
                        "line, payloads b64 — the default, debuggable) or "
                        "binary (u32 header_len | JSON header | u32 "
                        "payload_len | payload; push audio as raw <i2 PCM, "
                        "frames as raw <f4)")
    s.add_argument("--emit", choices=["b64", "list", "b64-batched"],
                   default="b64",
                   help="frame payload encoding: b64 float32 (compact), "
                        "JSON lists (debuggable, jsonl wire only), or "
                        "b64-batched (one frames_batch event per poll round)")
    s.add_argument("--metrics", default=None, help="JSON-lines metrics file")
    s.set_defaults(fn=cmd_serve)

    v = sub.add_parser("plot", help="4-panel inspection PNGs for wav files (needs matplotlib)")
    v.add_argument("files", nargs="+", help="wav paths, globs, or directories")
    v.add_argument("--config", default="classic13")
    v.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help=set_help)
    v.add_argument("--output-dir", "-o", required=True)
    v.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the panels' chain runs: cuda (default; exit 2 "
                        "without a card) or cpu")
    v.set_defaults(fn=cmd_plot)

    i = sub.add_parser("info", help="show versions, cards and configs")
    i.add_argument("--self-test", action="store_true",
                   help="classic13_deltas and logmel80 through the port on "
                        "--device and on the CPU against the float64 oracle")
    i.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the self-test's device besides the CPU: cuda "
                        "(default; exit 2 without a card) or cpu")
    i.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    return args.fn(args)
