#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mfcc_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py [--seed N]   # from the root of a checkout; needs one card

--seed (default 0) seeds the wav corpus of phase 22.

Phases, in order; any failure exits non-zero:
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. build every kernel source from the checkout (one nvcc each, all started
     together, with phase 20's three breakdown cuts of the front-end) and
     print ptxas usage; then, from the card, the registers, local (spilled)
     bytes and blocks an SM of each FFT-form instantiation of the front-end
     kernel (no spills, 80 registers or fewer; classic13, logmel80,
     whisper80 and kaldi_mfcc with dither 1.0 at three blocks an SM or more;
     the fused resample's int16 instantiation at three for mfcc39_48k and
     two for mfcc39_44k, its float32 one printed; the Bluestein form at
     n_fft 404 at two, and with dither printed), of each block-plan
     instantiation at n_fft 1102 (no spills) and of each bf16x3
     instantiation (no spills);
  3. path classic13_deltas (b64 x 10 s int16 PCM at 16 kHz, lengths
     n - 571*i): the front-end kernel against its plain version (the
     test_kernel_matches_jnp_twin gates, int16 rows ≡ float32 rows bitwise,
     boundary lengths, garbage past each length leaving the output
     unchanged); the kernel's n_valid and frame mask bitwise
     chain.num_valid_frames / frame_mask of the same card lengths (also at
     lengths 0, 1, L - 1, L, L + 1 and T); then `chain.extract_batch` with
     every launch count set to 0 just before and read just after (the
     front-end kernel and the feature-tail kernel once each): features [64,
     999, 39], finite, pad frames exactly 0, within 5e-4 of the CPU chain and
     of the float64 chain on four rows; the tail kernel on the front-end's
     own prefix against its plain version (max(2e-4, 2e-5 max|f|)), masks
     equal, pad rows 0, and extract_batch's features bitwise the tail's;
     times (the tail kernel's device time with its share of the bound and
     the torch epilogue, in turns; the epilogue's device kernels and time);
     the profiler's device kernels of one step with int32 lengths on the
     card, which must be the front-end and the tail alone;
  4. path mfcc39_48k (b64 x 10 s int16 PCM at 48 kHz, lengths
     480,000 - 1,713*i): the fused resample of the front-end kernel against
     its plain version (prefix gates, int16 ≡ float32 bitwise, dirty tails,
     boundary input lengths at the 16 kHz frame and first-tile edges); then
     `extract_batch`, counted (fused resample 1, tail 1, the others 0): [64, 999, 39]
     within 8e-4 of the CPU chain and of the float64 chain; the fused
     instantiations' registers, spills and blocks an SM; times, the fused
     kernel beside the two-launch split (resample.cu, then the plain form)
     in turns;
  5. path resample_batch (the same rows as float32 [64, 480,080], 48 kHz ->
     16 kHz): the polyphase kernel, counted, within 1e-5 of each row's max
     |x| of its plain version and of scipy float64 on four rows; refusals
     (float64, non-contiguous rows, a config the port lacks); times,
     blocks an SM and the share of the bound;
  6. path mfcc39_44k at b64 x 10 s (lengths 441,000 - 1,573*i): the fused
     resample against its plain version (prefix gates, int16 ≡ float32,
     dirty tails), `extract_batch` counted and within 8e-4 of the CPU chain
     and of the float64 chain; its instantiations' registers and blocks an
     SM, its time beside the two-launch split in turns and its bound (no
     single PyTorch call computes a 160/441 resample, so no library time);
     mfcc39_48k with dither 0.5 at b16: the fused form's dither against its
     plain version, int16 ≡ float32 and two runs bitwise;
  7. path kaldi_mfcc with dither 1.0 (Kaldi's default; b64 x 10 s int16,
     lengths 160,000 - 571*i, "drop" framing, 998 frames): the dither and
     conditioning branches against their plain version (ln_floor epilogue),
     int16 ≡ float32, dirty tails ≡ clean, two runs of one seed bitwise
     equal, another seed different, one utterance at two rows bitwise equal
     on its valid frames, rows shorter than a frame giving 0 frames without
     a launch; `extract_batch` counted (front-end 1 with its dither and
     conditioning branches, the others 0), [64, 998, 13] within 5e-4 of the
     CPU chain and of the float64 chain on four rows; times, beside the
     kernel without dither and without conditioning on the same rows; then
     kaldi_mfcc without dither and kaldi_fbank at b16, counted, within 5e-4
     and 1e-4 of the CPU chain;
  8. path logmel80 (BASELINE config #3, b256 x 10 s int16): the ln_stab
     epilogue against its plain version, `extract_batch` counted, timed
     beside torch.fft.rfft on the same frames,
     [256, 999, 80] within the two-regime log-mel gate (1e-4 on bins within
     40 dB of the row max, 1e-5 of the row max in the linear domain) of the
     CPU chain and of the float64 chain on four rows; times; the db
     epilogue against its plain version at b16;
  9-11. paths kaldi_plp, kaldi_spectrogram and ssc26 (b64 x 10 s int16,
     lengths 160,000 - 571*i): the kernel's plp, spectrogram and ssc
     feature kinds against their plain version under the family's prefix
     gate (PLP's raw mel lanes linear, 1e-5 of the row max; the log power
     bins two-regime, 1e-4 within 40 dB of the row max; centroids rtol 1e-4,
     atol 5e-3), int16 ≡ float32 and dirty tails ≡ clean bitwise; then
     `extract_batch` counted (front-end 1 with that branch, conditioning 1
     for the Kaldi configs, the others 0), its features within the family's
     gate of the CPU chain and of the float64 chain on four rows
     (`testing.FAMILY_GATES`); times;
  12. path whisper80 (b64 x 30 s int16 [64, 480,000], every row Whisper's
     padded chunk, 3,000 frames): the centered staging, the Stockham
     400-point FFT and the log10_floor epilogue against the float64 plain
     version (prefix gates, log10 lanes read as natural logs), int16 ≡
     float32; `extract_batch` counted (front-end 1 with its centered and
     Stockham form), [64, 3000, 80] within 5e-5 of the CPU chain and
     1e-5 of the float64 chain on four rows (the whisper gates); times;
  13. whisper80 ragged at b16 (lengths 480,000 - 1,713*i, and 801, 401, 250
     and 90 samples, which wrap the reflection more than once);
  14. centered framing with dither: kaldi_mfcc "center" with conditioning
     and dither 1.0, classic13_deltas "center" with dither and signal
     pre-emphasis (at the source index, across the reflection seams), b16;
  15. the Bluestein FFT: classic13 at n_fft 404 (P = 512) and 551 (odd, P =
     960), b16, through extract_batch and through
     fused_logmel_stages(dft_passes="fp32"), each counted (Bluestein 1,
     the block plan 0), against the float64 plain version, the n_fft 404
     features' error against the CPU chain printed; timed beside
     rfft(n=...) and the bound; then n_fft 1102, a size whose warp-plan rows
     do not fit, the same through the block FFT plan (counted), timed: under
     its plain version's time and within 5x rfft(n=1102), or it fails;
  16. a radix-3 Stockham size (classic13 at n_fft 480), b16;
  17. frames longer than n_fft (kaldi_mfcc with 40 ms frames at n_fft 512,
     with raw and windowed energy), b16;
  18. rows over the reference's 8 MiB slab bound (its view mode):
     classic13_deltas at b2 x 140 s, timed (profiler device time);
  19. the feature tail's branches at b16 through
     `fused_logmel_stages(feature_tail=True)`, counted, each against its
     plain version on the same prefix: utterance CMVN with and without
     variance normalization, one delta order, no energy, Kaldi's energy
     floor; rows at n_valid 0, 1, 2 and the tile edges 31-33 and 64, a zero
     row and a 100 Hz tone (near-constant CMVN columns are held before the
     division, `testing.cmvn_column_scale`);
  20. the bf16x3 form (wgmma over a ring of bulk-copied matrix stages):
     classic13 b64 x 10 s through `fused_logmel_stages(dft_passes="bf16x3")`,
     counted, against its plain version and the float64 plain version (loud
     bins 1e-3), its SASS checked for HGMMA and bulk copies, timed beside
     the Stockham form in turns, with a staging / product / projection
     breakdown from scripts/frontend_breakdown.py's cuts (profiler device
     time); kaldi_mfcc with dither 1.0 at n_fft 404, b16;
  21. n_fft 2048 (classic13, 26 filters), b16: the Stockham form at 1,024
     points (8*8*8*2) against the float64 plain version, counted, its
     features within 5e-4 of the CPU chain.
  22. the corpus path, on a corpus written from --seed into a temporary
     directory (256 PCM16 files of 1-10 s at 16 kHz, every fourth in a
     speaker subdirectory, two of 75 and 90 s, a corrupt file and one at 8
     kHz; 32 files at 48 kHz and one of 90 s): (a) `cli.main(["extract",
     ..., "--config", "classic13_deltas", "--feed", "direct"])` on the
     card, with every count set to 0 just before and read just after: one
     shard a batch and one a long file, the decode errors and wrong rates
     counted, front-end launches = batches + the long files' segment groups
     and tail launches = batches + long files (no other kernel), every
     utterance within 5e-4 of the CPU chain's `extract_single` on the same
     decoded samples; (b) classic13_deltas_gcmvn's two passes (`extract
     --cmvn-stats`, then `apply-cmvn`): the moments within 1e-5 of the same
     run with `--device cpu` (Σx relative to sqrt(n Σx²), Σx² relative to
     itself), the normalized corpus with mean 0 and std 1 within 1e-3 per
     dimension; (c) mfcc39_48k: `resample.cu` launched once (for the 90 s
     file), whose features are within 8e-4 of the CPU chain's monolithic
     extraction; `resample.cu` timed on a 90 s 44.1 kHz row beside its
     bound; (d) `--format htk` and `--format kaldi` read back equal to the
     npz run; (e) with CUDA_VISIBLE_DEVICES="" `python -m
     mfcc_tpu_torch.cli extract --device cuda` exits non-zero and writes no
     shard; (f) the corpus audio-s/s by wall clock, decode and writes
     included, the share of it in `sharded_extract_batch` (host wall, and
     device span by CUDA events), and the host-fed step from pinned rows
     beside pageable ones, in turns; (g) `extract --feed mp` (feed worker
     processes decoding into shared-memory slabs, pinned once) on the same
     corpus, counted: the launches of (a) and (a)'s shards, their npz
     members bytewise; (h) a corpus of 2,048 PCM16 files of 1-10 s
     (~11,000 audio-s, ~350 MB) written from --seed: after one warm-up run
     of the worker pool, `--feed mp` and `--feed direct` timed in turns
     (mp, direct, direct, mp), each run's audio-s/s by wall clock and the
     share of the wall the CLI waits on the feed, the two feeds' shards
     equal, no slab file of this process left in /dev/shm; then the feeds
     alone on that corpus (no extraction, no writes; a warm-up, then two
     turns a, b, ..., b, a): the header parse serially and through the
     worker pool, `stream_batches_direct` and `stream_batches_mp` at the
     CLI's defaults with a fresh pinned row pool a run, as the CLI makes
     one on a card, each with its audio-s/s and µs a file; (i)
     `io.ShardDataset` over the mp run's shards: every utterance equal to
     `read_shard`'s, the frames counted from the markers, split(i, 4) a
     partition, two shuffled epochs in different orders.
  23. streaming and serving (classic13_deltas, K = 16): (b) the front-end
     kernel's block launch (rows whose sample 0 is the pre-context) against
     its plain version at the prefix gates, with a zero and a dirty
     pre-context and valid 0, 1, L - 1, L, L + 1 and span, samples past
     valid ≡ zeros bitwise, and 64 rows at K = 16 and 128; (a)
     `MultiStreamExtractor` with 256 streams of 1-10 s pushed in 160 ms
     chunks (2,560 samples) and polled after each turn, every count set to
     0 before each round and read after it: the block launch once where a
     stream had a block, the tail once a window width (at most twice), no
     other kernel of the port; frame counts equal the offline ones, every
     stream within 5e-4 of the card's offline `extract_batch` and four of
     the float64 chain, and bitwise its own single-stream
     `StreamingExtractor` run; the profiler's device ops of one 256-stream
     round (one block launch, at most two tail launches); (c) classic13,
     ssc26, logmel80, classic13_deltas_gcmvn (with moments), mfcc39_48k,
     mfcc39_44k, kaldi_mfcc, kaldi_spectrogram, kaldi_fbank and kaldi_plp
     at 16 streams of 1-4 s, counted the same way (their conditioning, PLP,
     spectrogram and SSC branches once a round), within their family's gate
     of the card's offline chain; (d) `StreamingExtractor` at K = 16 and
     128 on one 10 s stream within 5e-4 of offline; (e) `python -m
     mfcc_tpu_torch.cli serve` as a subprocess with 8 sessions on `--wire
     jsonl` and on `--wire binary --emit b64-batched`, each session's
     frames bitwise the in-process pool's, and with CUDA_VISIBLE_DEVICES=""
     exit 2 and no event; (f) a steady poll round's host wall and device
     busy time at 16, 64 and 256 streams, the host µs a stream-block, the
     projected real-time streams (a block's 160 ms over it), and the
     single-stream push of a block at K = 16 and 128 by wall and by CUDA
     events; the phase's time and the whole script's.
  24. the training path, `chain.extract_batch_diff` (the kernels forward,
     the plain chain's VJP backward), classic13_deltas at b64 x 10 s float32
     rows (lengths 160,000 - 571*i), loss (feat**2).sum(), with every count
     set to 0 just before a training step and read just after (the
     front-end and the tail once each, nothing else: the backward launches
     no kernel of the port): the forward bitwise `extract_batch`'s, the
     gradient finite and within 1e-3 (relative max diff) of the float64
     plain chain's on the card, a row-0 loss giving exactly 0 gradient on
     the other rows and past row 0's length; the forward and backward ms by
     CUDA events, the backward's device kernels and busy time (profiler),
     the peak device memory of a step, the step's audio-s/s (of the rows'
     valid samples); then every named config and kaldi_mfcc with dither 1.0
     at b4 x 1 s, counted (one front-end launch, the dither branch once
     when dithering, no polyphase kernel): the forward bitwise, the
     gradient within 1e-3 of the float64 plain chain's.
  25. the tools: `cli convert` of phase 22's npz shards to HTK and to Kaldi,
     byte-identical to `io/htk.py` / `io/kaldi.py` writing the same
     features (through `ShardWriter`); `cli info --self-test` on the card
     (classic13_deltas and logmel80 on the card and the CPU against the
     float64 oracle at 2e-3) must PASS; `utils.trace.stage_times` on the
     main path's batch gives four non-negative keys (CUDA events). `cli
     plot` is not driven (the card's machine has no matplotlib).
  26. resampled rows, every framing, DFT route and ratio (the split route:
     resample.cu on the rows, zeroed past each length, then the plain form,
     picked by the layout mirrors for centered framing and for fused
     layouts over the block): (1) whisper80 fed 48 kHz, b64 x 30 s int16
     [64, 1,440,000], every row a full chunk: against the float64 plain
     version (prefix gates, narrow lanes per bin), int16 ≡ float32,
     counted (resample.cu 1, the plain form 1 on its centered branch, the
     fused form 0), extract_batch within 5e-5 of the CPU chain and 1e-5 of
     the float64 chain, the profiler's device kernels of a step (resample.cu,
     the front-end and the whisper norm's torch kernels, the same as a 16 kHz
     whisper80 step's at that shape, nothing else), times beside conv1d +
     rfft(n=400); (2) classic13_deltas "center" at 44.1 kHz, b64 x 10 s:
     exactly three device kernels a step (resample, front-end, tail),
     features within 8e-4; (3) kaldi_mfcc "center" with dither 1.0 at 48
     kHz, b16: the dither branch once, two runs and int16/float32 rows
     bitwise equal; (4) kaldi_plp, kaldi_spectrogram and ssc26 "center" at
     48 kHz, b16, each at its family's gate; (5) bf16x3 in the fused form on
     mfcc39_48k and mfcc39_44k, b64 x 10 s int16: against its plain version
     at the bf16x3 gates, int16 ≡ float32, the route and plan printed,
     registers, spills and blocks an SM, its time beside the radix-4 fused
     kernel's in turns; (6) classic13_deltas at 192 kHz, b16 x 10 s: the
     split route, counted, features within 8e-4; (7) resample_batch at 192
     kHz -> 8 kHz (a reduced tile) and 16,000 -> 15,999 (the taps from
     device memory) on four 10 s rows, within 1e-5 of each row's max |x| of
     the plain version and of scipy float64, with the tile and tap branch
     printed, counted by branch, timed beside the bound.
  27. the block FFT plan at the sizes the warp plan refused: librosa's
     framing (logmel80 at 22.05 kHz, n_fft 2048, 2048-sample frames, hop
     512, 128 mels), b64 x 10 s int16: the kernel against the float64 plain
     version, int16 ≡ float32, two runs and dirty tails bitwise, the counts
     and mask, extract_batch counted (front-end 1 in the block plan) within
     the two-regime log-mel gate of the CPU chain and the float64 chain, one
     block launch (row origin 1) at frames [100, 140) against the offline
     prefix, timed (device time, events, plain, rfft(n=2048), bound, a
     profiled step); classic13_deltas at n_fft 4096 (Stockham, 2,048
     points) and 2501 (Bluestein, P = 4,096, its tables in device memory),
     b16, through `small_path` (front-end and tail counted), each timed the
     same way.
  28. the gather plan (every hop and frame length) and the feature tail's
     split for wide cepstra: librosa's melspectrogram(n_fft=8192) framing
     (logmel80 at 22.05 kHz, 8192-sample frames, hop 2048, 128 mels), b64
     x 30 s int16, as phase 27 holds librosa's 2048 framing (the float64
     plain version, the bitwise invariances, the counts and mask,
     extract_batch counted and gated, the step's device kernels and idle
     share, device time beside rfft(n=8192)); at b16 through `small_path`,
     timed: classic13_deltas at a 0.2 s hop and with 3 s frames, kaldi_mfcc
     with dither at 0.25 s, whisper80 at 0.2 s, n_fft 4096 at hop 2048 at
     44.1 kHz, n_fft 6001 (tables in device memory); whisper80 fed 48 kHz
     at 0.2 s (the split route, then the gather plan); the block launch at
     0.2 s bitwise the offline prefix; the tail's split at 170 cepstra,
     window 8 and 200, window 40, each pass counted, against its plain
     version on the front-end's own prefix at the tail's gate, rows 0-3 of
     the features against the float64 chain (the card's gated, the CPU
     chain's printed), timed.
  29. every n_fft past the gather plan's layouts (`any_n_fft_path`,
     `ANY_NFFT`): the cluster plan (each frame's FFT rows over a
     thread-block cluster of 2, 4 or 8 blocks), every gate on its default
     launch, beside the parent's plans it replaced ("gather_bands",
     "gather_rows") forced, each counted and gated against the float64
     plain version and timed; the other cluster sizes forced at n_fft
     32,768 within the gates.
  30. the bf16x3 opt-in at every layout (`bf16x3_plans_path`,
     `BF16X3_PLANS`): its block plans ("pass", "gather", "gather_bands",
     "gather_out") through fused_logmel_stages(dft_passes="bf16x3"),
     classic13_deltas at n_fft 4096 b64 x 10 s and the other cases at b16
     (b4 for n_fft 24,000 and 32,768 and 2,000 filters), each printing its
     plan, threads, registers, local memory and blocks an SM, counted by
     plan, against its plain
     version at the bf16x3 gates and the float64 plain version on rows 0-1,
     int16 == float32 and two runs bitwise, the counts and mask, no spills;
     device time beside rfft(n=n_fft), the function's bound, the three
     products at the bf16 peak and the matrix each tile reads.
  31. every filter count (`many_filters_path`, `MANY_FILTERS`): the packed
     mel table without a filter field, and the wide plan (a tile's power
     rows in shared memory, the projection filter by filter), with the plan
     it replaced ("gather_bands" or "gather_sums") forced beside it and held
     to it bitwise or its largest difference printed: classic13_deltas at
     40,000 and 60,000 filters, b16 x 10 s; ssc26 at 30,000 filters and
     n_fft 4,096, b16; logmel80 at 33,000, b4; bf16x3 at
     40,000 ("gather_out") through fused_logmel_stages(dft_passes="bf16x3"),
     b16; n_fft 131,072 at 16,385 filters (past the old 14-bit field; the
     cluster plan, and "gather_rows" forced beside it), b2 x
     30 s, where the host's memory holds its dense mel matrix and the run
     is under HOST_BOUND_AFTER_S old. Each against
     its plain version on the card (float64, the first and last rows;
     the fp32 one printed; filters
     of at most two weights at the per-bin gate, NaN where an SSC filter has
     no weight, in the same places), int16 == float32, two runs, a NaN-filled
     workspace and a persistent grid of 7 blocks, bitwise; the counts and
     mask; extract_batch counted (fused_logmel_stages for bf16x3); the
     tail against its plain version on the kernel's prefix, the features on
     rows 0-1 within their family's gate of the float64 chain; device time,
     the plain version, rfft(n=n_fft) and the bound; the tail's split (its
     base kernel's stretches past 1,024 lanes) timed beside its plain version.
  Phases 4, 6, 7 and 12-21 hold the kernel's n_valid and frame mask
  bitwise to chain.num_valid_frames / frame_mask of the same card lengths
  ("drop", "center", "center_reflect" with drop_last_frame, rows resampled
  from 48 and 44.1 kHz; each also at lengths 0, 1, L - 1, L, L + 1 and T);
  phase 7 times the dithered front-end beside the undithered one in turns.
  Phases 13-18 each hold the kernel to its plain version (whisper80 and the
  n_fft 404, 551, 1102 and 480 sizes: the float64 plain version, computed
  on the CPU), check int16 ≡
  float32, two runs and dirty tails ≡ clean bitwise, and count
  `extract_batch` with its features within the config's gate of the CPU
  chain and the float64 chain. Every mfcc path's extract_batch (phases 3,
  4, 6, 7 and 14-18) launches the feature tail once.
Times are CUDA events after warm-up (median of launches with the 64 MiB
flush buffer zeroed before each, beyond the 50 MB L2), each beside the
card's name and power limit. `bound_ms` is computed from each run's inputs
against the H100 SXM peaks (3.35 TB/s, 67 TFLOP/s fp32 without tensor
cores) at the function's minimum: an n_fft/2-point complex FFT counted by
the split-radix formula (whatever form the kernel takes: Stockham or
Bluestein, in either plan), the real split with its 1/2 scalings folded into the
power scale, the mel sums
over the filters' nonzero weights (none for a spectrogram; for SSC the
per-bin clamps, two sums per weight and a division per filter, and no
energy), the logs (none for PLP), the conditioning's passes over each
frame, the dither's 30 float operations per sample that holds signal (its
25 integer hash operations counted at the fp32 rate, which no int32 rate of
the card exceeds, so the bound stays a lower bound; ln and sqrt one each),
and the resample's taps (the 61 symmetric taps of 48 kHz -> 16 kHz folded:
91 FLOP per output); the bf16x3 form is held to the same function's
bound (its matrix among the bytes), its three tensor passes printed beside
at the bf16 peak; the feature tail's bound counts the prefix rows of valid
frames, all of its features and its per-frame products and delta sums
(`tail_bound`). No PyTorch call
computes the contract noise, the conditioning or the cepstral tail, so
those entries have no library time. A
torch.profiler pass over five steps of each extract_batch path gives device
kernels per step, device busy time and the step's idle share.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a card it exits 2 and prints neither.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

B, SECONDS = 64, 10
B_SMALL = 16  # depth of the secondary paths (dithered 48 kHz, kaldi_fbank, db)
B_LOGMEL80 = 256  # logmel80 is BASELINE config #3, "batch-256"
WHISPER_SECONDS = 30  # Whisper's padded chunk
WHISPER_SHORT = [801, 401, 250, 90]  # rows of the ragged whisper80 batch that wrap
LONG_SECONDS = 140  # 2.24 M samples a row, over the reference's 8 MiB slab (~131 s)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32, outside the tensor cores
PEAK_BF16_FLOPS = 989.4e12  # H100 SXM dense bf16 on the tensor cores
BOUNDARY_LENGTHS = [0, 1, 399, 400, 401, 32 * 160 - 1, 32 * 160, 32 * 160 + 1]
# at 48 kHz one 16 kHz frame is 1,200 input samples; 16,080 ends the first 32-frame tile
RS_BOUNDARY_LENGTHS = [0, 1, 2, 3, 1199, 1200, 1201, 16079, 16080, 16081]
# the tail's rows: "pad" framing gives n_valid 0, 1, 1, 1, 2, 31, 32, 33 and 64
# frames (the tile edges) at these lengths
TAIL_LENGTHS = [0, 1, 399, 400, 401, 5200, 5360, 5361, 10480]
TAIL_CASES = (
    ("classic13_deltas", {"cmvn": "utterance"}),
    ("classic13_deltas", {"cmvn": "utterance", "cmvn_var_norm": False}),
    ("classic13", {"deltas": 1}),
    ("classic13", {"append_energy": False}),
    ("kaldi_mfcc", {"energy_floor": 1e-3}),
)
SOURCES = ("frontend", "resample", "tail")
KERNELS = {
    "frontend": {
        "name": "frontend_logmel",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "fused": {
        "name": "frontend_logmel_resample",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:493",
    },
    "resample": {
        "name": "polyphase_resample",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/resample.cu",
        "replaces": "mfcc_tpu/kernels/resample.py:79",
    },
    "conditioning": {
        "name": "frontend_logmel_conditioning",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:620",
    },
    "dither": {
        "name": "frontend_logmel_dither",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:537",
    },
    "plp": {
        "name": "frontend_plp",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:682",
    },
    "spectrogram": {
        "name": "frontend_spectrogram",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:308",
    },
    "ssc": {
        "name": "frontend_ssc",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:965",
    },
    "whisper": {
        "name": "frontend_whisper80_mixed_radix_centered",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "block_fft": {
        "name": "frontend_block_fft_bluestein_1102",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:807",
    },
    "block_fft_2501": {
        "name": "frontend_block_fft_bluestein_2501_global_tables",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:807",
    },
    "block_fft_4096": {
        "name": "frontend_block_fft_stockham_4096",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "block_fft_librosa": {
        "name": "frontend_block_fft_librosa_22k_2048",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "bluestein": {
        "name": "frontend_bluestein_dft",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:807",
    },
    "long_rows": {
        "name": "frontend_rows_over_the_slab_bound",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:571",
    },
    "feature_tail": {
        "name": "feature_tail",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/tail.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:714",
    },
    "bf16x3": {
        "name": "frontend_bf16x3_dft",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:857",
    },
    "bf16x3_fused": {
        "name": "frontend_bf16x3_fused_resample",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:857",
    },
    "centered_resampled": {
        "name": "resample_then_frontend_centered_whisper80_48k",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "resample_reduced_tile": {
        "name": "polyphase_resample_reduced_tile",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/resample.cu",
        "replaces": "mfcc_tpu/kernels/resample.py:79",
    },
    "gather_librosa_8192": {
        "name": "frontend_gather_librosa_22k_8192_hop_2048",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "gather_hop": {
        "name": "frontend_gather_classic13_deltas_hop_0.2s",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "gather_long_frames": {
        "name": "frontend_gather_classic13_deltas_frames_3s",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "gather_conditioning_dither": {
        "name": "frontend_gather_kaldi_mfcc_dither_hop_0.25s",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:620",
    },
    "gather_centered": {
        "name": "frontend_gather_whisper80_hop_0.2s",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "gather_44k_4096": {
        "name": "frontend_gather_44k_4096_hop_2048",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "gather_bluestein_6001": {
        "name": "frontend_gather_global_bluestein_6001",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:807",
    },
    "gather_split_48k": {
        "name": "resample_then_frontend_gather_whisper80_48k_hop_0.2s",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:905",
    },
    "tail_split_170": {
        "name": "feature_tail_split_170_cepstra_window_8",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/tail.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:714",
    },
    "tail_split_200": {
        "name": "feature_tail_split_200_cepstra_window_40",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/tail.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:714",
    },
    "resample_global_taps": {
        "name": "polyphase_resample_global_taps",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/resample.cu",
        "replaces": "mfcc_tpu/kernels/resample.py:79",
    },
    **{key: {"name": f"frontend_{key}", "route": "cuda", "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
             "replaces": replaces}
       for key, replaces in (("gather_bands_librosa_44k_16384", "mfcc_tpu/kernels/frontend.py:905"),
                             ("gather_bands_bluestein_7001", "mfcc_tpu/kernels/frontend.py:807"),
                             ("gather_bands_bluestein_12502", "mfcc_tpu/kernels/frontend.py:807"),
                             ("gather_bands_whisper80_16384", "mfcc_tpu/kernels/frontend.py:905"),
                             ("gather_rows_bluestein_13001", "mfcc_tpu/kernels/frontend.py:807"),
                             ("gather_rows_32768", "mfcc_tpu/kernels/frontend.py:905"),
                             ("gather_rows_48k_65536", "mfcc_tpu/kernels/frontend.py:905"),
                             ("gather_rows_131072", "mfcc_tpu/kernels/frontend.py:905"))},
    **{key: {"name": f"frontend_{key}", "route": "cuda", "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
             "replaces": "mfcc_tpu/kernels/frontend.py:857"}
       for key in ("bf16x3_gather_4096", "bf16x3_gather_2245", "bf16x3_gather_8192", "bf16x3_gather_hop_0.1",
                   "bf16x3_gather_frames_1.1s", "bf16x3_gather_kaldi_dither_4096", "bf16x3_gather_ssc26_4096",
                   "bf16x3_gather_kaldi_plp_4096", "bf16x3_split_48k_hop_0.1", "bf16x3_gather_out_librosa_8192",
                   "bf16x3_gather_24000", "bf16x3_gather_out_2000_filters", "bf16x3_pass_10ms_4096",
                   "bf16x3_gather_bands_32768")},
    **{key: {"name": f"frontend_{key}", "route": "cuda", "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
             "replaces": replaces}
       for key, replaces in (("gather_bands_40000_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("gather_sums_60000_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("gather_sums_ssc26_30000_filters", "mfcc_tpu/kernels/frontend.py:965"),
                             ("gather_bands_logmel80_33000_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("bf16x3_gather_out_40000_filters", "mfcc_tpu/kernels/frontend.py:857"),
                             ("gather_rows_131072_16385_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("cluster_131072_16385_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("wide_40000_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("wide_60000_filters", "mfcc_tpu/kernels/frontend.py:905"),
                             ("wide_ssc26_30000_filters", "mfcc_tpu/kernels/frontend.py:965"),
                             ("wide_logmel80_33000_filters", "mfcc_tpu/kernels/frontend.py:905"))},
    # the cluster plan at phase 29's cases
    **{key: {"name": f"frontend_{key}", "route": "cuda", "source": "mfcc_tpu_torch/kernels/csrc/frontend.cu",
             "replaces": replaces}
       for key, replaces in (("cluster_librosa_44k_16384", "mfcc_tpu/kernels/frontend.py:905"),
                             ("cluster_bluestein_7001", "mfcc_tpu/kernels/frontend.py:807"),
                             ("cluster_bluestein_12502", "mfcc_tpu/kernels/frontend.py:807"),
                             ("cluster_whisper80_16384", "mfcc_tpu/kernels/frontend.py:905"),
                             ("cluster_bluestein_13001", "mfcc_tpu/kernels/frontend.py:807"),
                             ("cluster_32768", "mfcc_tpu/kernels/frontend.py:905"),
                             ("cluster_48k_65536", "mfcc_tpu/kernels/frontend.py:905"),
                             ("cluster_131072", "mfcc_tpu/kernels/frontend.py:905"))},
    "tail_base_60000_filters": {
        "name": "feature_tail_split_base_60000_filters",
        "route": "cuda",
        "source": "mfcc_tpu_torch/kernels/csrc/tail.cu",
        "replaces": "mfcc_tpu/kernels/frontend.py:714",
    },
}
# kernels whose case a host without the memory leaves out (phase 31)
HOST_BOUND_KERNELS = {"gather_rows_131072_16385_filters", "cluster_131072_16385_filters"}
FAMILY_PATHS = (("kaldi_plp", 13), ("kaldi_spectrogram", 14), ("ssc26", 15))  # (config, seed)
# librosa's default framing (librosa.feature.melspectrogram: sr 22,050, n_fft
# 2048, win_length n_fft, hop 512, 128 mels), a logmel80 override
LIBROSA = dict(sample_rate=22050, n_fft=2048, win_len_s=2048 / 22050, hop_s=512 / 22050, n_mels=128)
# dither: float operations per sample that holds signal (uniforms 4, ln,
# -2x, sqrt, cos(2 pi u) 20, r cos, sigma n, the add) and integer ones (two
# fmix32 16, row key 2, t / S and t % S, lane add, the two 16-bit halves
# and their conversions 4), both counted at the fp32 rate
DITHER_FLOPS, DITHER_INT_OPS = 30, 25


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}")


def check_prefix(testing, got, want, cfg, what: str, narrow=None) -> dict[str, float]:
    errs = testing.prefix_errors(got, want, cfg.n_mels, cfg.log_kind, cfg.features, narrow)
    print(f"  {what}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    failures = testing.prefix_failures(errs)
    check(not failures, f"{what}: within the kernel-vs-plain gates {failures or ''}")
    return errs


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over reps launches, L2 flushed before each."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def host_ms(torch, fn, reps: int = 7) -> float:
    """Median host-clock time of fn() through a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def trace(torch, fn, kernel_substr: str | None, steps: int = 5, warmup: int = 2):
    """(device events, the events whose name holds kernel_substr) of
    `steps` calls of fn, traced after `warmup` warm-up calls inside the same
    session (a session's first launches can be missed while tracing starts:
    one run saw 4 of 5 front-end records). A trace that still lost some of
    those kernels' records is taken again, up to three times; kernel_substr
    None takes the first trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warmup, active=steps, repeat=1)) as prof:
            for _ in range(warmup + steps):
                fn()
                torch.cuda.synchronize()
                prof.step()
        # device-side events only (a CPU op's self device time repeats its
        # kernels'), without the ProfilerStep ranges mirrored on the device
        on_device = [e for e in prof.events() if e.device_type.name == "CUDA"
                     and not e.name.startswith("ProfilerStep")]
        if kernel_substr is None:
            ours = []
            break
        ours = [e for e in on_device if kernel_substr in e.name]
        if len(ours) == steps:
            break
        print(f"  profiler: {len(ours)} of {steps} {kernel_substr} records, tracing again")
    return on_device, ours


def profile_step(torch, fn, kernel_substr: str | None, steps: int = 5):
    """(device kernels per step, device busy ms per step, ms of the kernels
    whose name holds kernel_substr per step, ms of the feature-tail kernels
    per step) over `steps` calls of fn (`trace`). The kernels' ms is None
    when their records stay incomplete: the profiler has lost every record
    of the feature tail in three traces in a row where other runs of the
    same code saw all; that is no fault of the port, and the caller says
    what it measures instead."""
    on_device, ours = trace(torch, fn, kernel_substr, steps)
    busy = sum(e.self_device_time_total for e in on_device) / 1e3 / steps
    ours_ms = sum(e.self_device_time_total for e in ours) / 1e3 / steps
    if kernel_substr is not None and len(ours) != steps:
        print(f"  (the profiler traced {len(ours)} of {steps} {kernel_substr} launches in three "
              "traces: their device time is not measured here)")
        ours_ms = None
    tail_ms = sum(e.self_device_time_total for e in on_device
                  if "tail_kernel" in e.name or "cmvn_kernel" in e.name) / 1e3 / steps
    return len(on_device) / steps, busy, ours_ms, tail_ms


def device_ms(torch, fn, kernel_substr: str | None = None, steps: int = 5) -> float:
    """Device time per call of fn's kernels whose name holds kernel_substr
    (with None, every kernel of fn), the 64 MiB flush buffer zeroed before
    each call (`trace`). CUDA events around one launch of a kernel of ~0.1
    ms also hold the host's time in the wrapper: at b16 they read n_fft 512
    at 0.2225 ms on one host. With None fn may launch several kernels a
    call (cuFFT does), so three traces are taken and the one with the most
    records is used, its count a whole number a call: one run read
    `rfft(n=4096)` at half its time from a trace that had lost some records.
    Where the profiler lost records in all three traces (with None: fewer
    kernel records than calls, or none whole; one run lost every record of
    `rfft(n=1102)`): CUDA events (said so)."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    best: list = []
    for _ in range(3 if kernel_substr is None else 1):
        on_device, ours = trace(torch, lambda: (flush.zero_(), fn()), kernel_substr, steps)
        if kernel_substr is None:  # fn's own kernels: a whole number a call
            ours = [e for e in on_device if "Fill" not in e.name and "Memset" not in e.name]
            if len(ours) >= steps and len(ours) % steps == 0 and len(ours) > len(best):
                best = ours
            if len(ours) < steps or len(ours) % steps:
                print(f"  profiler: {len(ours)} kernel records for {steps} calls, tracing again")
    if kernel_substr is None:
        ours = best
    if len(ours) < steps or (kernel_substr is not None and len(ours) != steps):
        print("  (the profiler lost records in three traces: CUDA events, the wrapper's host "
              "time included)")
        return cuda_ms(torch, fn)
    return sum(e.self_device_time_total for e in ours) / 1e3 / steps


class Counters:
    """The wrappers' launch counts, zeroed and read around one path."""

    def __init__(self, frontend, rs_kernel, tail):
        self.frontend, self.rs_kernel, self.tail = frontend, rs_kernel, tail

    def zero(self) -> None:
        self.frontend.launches = 0
        self.frontend.resample_launches = 0
        self.frontend.dither_launches = 0
        self.frontend.conditioning_launches = 0
        self.frontend.plp_launches = 0
        self.frontend.spectrogram_launches = 0
        self.frontend.ssc_launches = 0
        self.frontend.centered_launches = 0
        self.frontend.bluestein_launches = 0
        self.frontend.block_fft_launches = 0
        self.frontend.global_table_launches = 0
        self.frontend.gather_launches = 0
        self.frontend.gather_bands_launches = 0
        self.frontend.gather_rows_launches = 0
        self.frontend.gather_sums_launches = 0
        self.frontend.cluster_launches = 0
        self.frontend.wide_launches = 0
        self.frontend.bf16x3_launches = 0
        self.frontend.bf16_pass_launches = 0
        self.frontend.bf16_gather_launches = 0
        self.frontend.bf16_gather_bands_launches = 0
        self.frontend.bf16_gather_out_launches = 0
        self.frontend.block_launches = 0
        self.frontend.split_launches = 0
        self.rs_kernel.launches = 0
        self.rs_kernel.reduced_tile_launches = 0
        self.rs_kernel.global_tap_launches = 0
        self.rs_kernel.global_window_launches = 0
        self.tail.tail_launches = 0
        self.tail.tail_split_launches = 0
        self.tail.tail_base_launches = 0
        self.tail.tail_cmvn_launches = 0

    def read(self) -> dict[str, int]:
        return {
            "frontend": self.frontend.launches,
            "fused": self.frontend.resample_launches,
            "resample": self.rs_kernel.launches,
            "conditioning": self.frontend.conditioning_launches,
            "dither": self.frontend.dither_launches,
            "plp": self.frontend.plp_launches,
            "spectrogram": self.frontend.spectrogram_launches,
            "ssc": self.frontend.ssc_launches,
            "centered": self.frontend.centered_launches,
            "bluestein": self.frontend.bluestein_launches,
            "block_fft": self.frontend.block_fft_launches,
            "global_tables": self.frontend.global_table_launches,
            "gather": self.frontend.gather_launches,
            "gather_bands": self.frontend.gather_bands_launches,
            "gather_rows": self.frontend.gather_rows_launches,
            "gather_sums": self.frontend.gather_sums_launches,
            "cluster": self.frontend.cluster_launches,
            "wide": self.frontend.wide_launches,
            "bf16x3": self.frontend.bf16x3_launches,
            "bf16_pass": self.frontend.bf16_pass_launches,
            "bf16_gather": self.frontend.bf16_gather_launches,
            "bf16_gather_bands": self.frontend.bf16_gather_bands_launches,
            "bf16_gather_out": self.frontend.bf16_gather_out_launches,
            "tail": self.tail.tail_launches,
            "tail_split": self.tail.tail_split_launches,
            "tail_base": self.tail.tail_base_launches,
            "tail_cmvn": self.tail.tail_cmvn_launches,
            "block": self.frontend.block_launches,
            "split": self.frontend.split_launches,
            "reduced_tile": self.rs_kernel.reduced_tile_launches,
            "global_taps": self.rs_kernel.global_tap_launches,
            "global_window": self.rs_kernel.global_window_launches,
        }

    def expect(self, what: str, **want: int) -> dict[str, int]:
        """Checks the counts read after a path: `want` names the kernels
        launched, every other count must be 0."""
        got = self.read()
        check(got == {k: want.get(k, 0) for k in got}, f"{what} launched {want} and nothing else: {got}")
        return got


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    print(f"  bound: {nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us; {ops / 1e9:.3f} GFLOP "
          f"-> {t_ops * 1e3:.2f} us; bound {max(t_bytes, t_ops) * 1e3:.2f} us by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def frontend_ops(cfg, chain, frontend, torch, lens16, F) -> int:
    """Operations of the front-end's minimum for rows holding lens16 samples
    at 16 kHz: per sample its frames read (`framed_mask`), signal
    pre-emphasis and the dither (when cfg has them); per frame that holds samples (every frame of a non-empty row
    under centered framing), the conditioning over its L samples (when cfg
    has it), the window over the min(L, n_fft) it transforms, an
    n_fft/2-point complex FFT counted by the split-radix formula
    4H log2 H - 6H + 8 at H = n_fft/2 (the least count known for a power of
    two, and below any known count for other sizes: the bound counts the
    function, not the kernel's Stockham or Bluestein form), the real
    split, |X|^2, then by feature kind: mel over the nonzero weights with a
    clamp and log per filter (mfcc, logmel) or without (plp), a clamp and log
    per bin (spectrogram), or SSC's clamp per bin that a filter weighs, two
    sums per weight and a division per filter; the energy and its clamp (not
    for SSC)."""
    M, N, L = cfg.n_mels, cfg.n_fft, cfg.frame_length
    if chain.centered(cfg):
        frames = F * int(np.count_nonzero(np.asarray(lens16) > 0))
    else:
        frames = int(sum(min(F, math.ceil(x / cfg.frame_step)) for x in lens16))
    mel = chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"]
    nnz = int((mel != 0).sum())
    kind = frontend.feature_kind(cfg)
    projection = {
        "logmel": 2 * nnz + 2 * M,
        "plp": 2 * nnz,
        "spectrogram": 2 * M,
        "ssc": int((mel != 0).any(dim=1).sum()) + 4 * nnz + M,
    }[kind]
    Lk, H, bins = min(L, N), N / 2, cfg.n_bins
    real_bins = 2 - N % 2  # DC, and Nyquist for even n_fft
    conditioning = (
        2 * L * cfg.remove_dc_offset  # the mean and the centering
        + 2 * L * (cfg.energy_source != "pspec")  # raw or windowed frame energy
        + (2 * L - 1) * (cfg.preemph_mode == "frame" and cfg.preemph != 0.0)
    )
    per_frame = int(
        conditioning
        + Lk  # window
        + 4 * H * math.log2(H) - 6 * H + 8  # n_fft/2-point complex FFT, split radix
        + 14 * (N // 4 - 1) + 2  # real split; its 1/2 scalings fold into pscale
        + 3 * (bins - real_bins) + real_bins  # |X|^2
        + projection  # pscale folds into the weights
        + (bins * (cfg.energy_source == "pspec") + 1) * (kind != "ssc")  # energy, clamp
    )
    per_sample = (
        2 * (cfg.preemph_mode == "signal" and cfg.preemph != 0.0)
        + (DITHER_FLOPS + DITHER_INT_OPS) * (cfg.dither > 0.0)
    )
    print(f"  front-end: {frames} frames x {per_frame} operations ({conditioning} of "
          f"conditioning) + {per_sample} per sample of pre-emphasis and dither")
    read = sum(int(framed_mask(cfg, int(n), F).sum()) for n in lens16) if per_sample else 0
    return per_sample * read + frames * per_frame


def resample_ops(R, up: int, down: int, lens_out, cfg=None, F: int = 0) -> int:
    """FLOP of the polyphase FIR's minimum for outputs [0, n) of each row,
    or with cfg, for the outputs its F frames read (`framed_mask`): 2*n_p - 1
    for the n_p nonzero taps of the output's phase, or with the symmetric
    taps of up = 1 folded, ceil(n/2) products and n - 1 sums."""
    d = R.polyphase_design(up, down)
    nz = (d["table"] != 0).sum(axis=1)
    outs = [np.arange(int(n), dtype=np.int64) if cfg is None
            else np.nonzero(framed_mask(cfg, int(n), F))[0] for n in lens_out]
    if d["up"] == 1:
        return sum(j.size for j in outs) * int((nz[0] + 1) // 2 + nz[0] - 1)
    per_phase = 2 * nz - 1
    return sum(int(per_phase[(j * d["down"] + d["half_len"]) % d["up"]].sum()) for j in outs)


def dirty_rows(torch, audio, lengths, seed: int):
    """audio with int16-range garbage in place of every sample past each length."""
    t = torch.arange(audio.shape[1], device=audio.device)[None, :]
    garbage = torch.randint(-32768, 32767, audio.shape, dtype=torch.int16, device=audio.device,
                            generator=torch.Generator(audio.device).manual_seed(seed))
    return torch.where(t < lengths[:, None], audio, garbage.to(audio.dtype))


def edge_lengths(cfg, T: int) -> list[int]:
    """0, 1, a frame length less one, the frame length and one more, in the
    rows' own samples (input samples for resampled rows), and T."""
    L = -(-cfg.frame_length * (cfg.input_sample_rate or cfg.sample_rate) // cfg.sample_rate)
    return [0, 1, L - 1, L, L + 1, T]


def check_counts(torch, frontend, audio, lengths, cfg, what: str, dft_passes: str = "radix4") -> None:
    """The front-end kernel's n_valid and frame mask (`logmel_prefix_counts`)
    bitwise equal to chain.num_valid_frames / chain.frame_mask of the same
    card lengths (`frame_counts_reference`: of the output lengths for
    resampled rows), on the batch and on its first rows at `edge_lengths`."""
    T = audio.shape[1]
    edge = torch.tensor(edge_lengths(cfg, T), dtype=torch.int32, device=audio.device)
    pick = torch.arange(edge.numel(), device=audio.device) % audio.shape[0]
    for rows, lens, tag in ((audio, lengths, "the batch"),
                            (audio[pick].contiguous(), edge, f"lengths {edge.tolist()}")):
        prefix, nv, mask = frontend.logmel_prefix_counts(rows, lens, cfg, dft_passes=dft_passes)
        want_nv, want_mask = frontend.frame_counts_reference(lens, cfg, prefix.shape[1])
        check(torch.equal(nv, want_nv) and torch.equal(mask, want_mask),
              f"{what} ({cfg.frame_tail}{', drop_last_frame' if cfg.drop_last_frame else ''}), {tag}: "
              "the kernel's n_valid and mask == chain.num_valid_frames / frame_mask, bitwise")


def in_turns(torch, fns, reps: int = 20) -> list[float]:
    """`cuda_ms` of each fn, in turns (a, b, ..., b, a); the mean of each
    fn's two runs."""
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    runs = [[] for _ in fns]
    for i in order:
        runs[i].append(cuda_ms(torch, fns[i], reps=reps))
    return [float(np.mean(r)) for r in runs]


def step_kernels(torch, fn, steps: int = 5, kernel_substr: str = "tail_kernel"
                 ) -> tuple[float, dict[str, float]]:
    """(device events a call, {event name: events a call}) over `steps`
    traced calls of fn after warm-up calls (`trace`, which retraces where it
    lost records of the kernels named by kernel_substr); a trace that lost
    some front-end records, or some records of any kernel (a count that is
    not whole a call: two runs traced 4 of 5 resample.cu launches at phase
    26, one in three traces in a row), is taken again with two more warm-up
    calls, up to eight times, each retrace said."""
    for attempt in range(8):
        on_device, _ = trace(torch, fn, kernel_substr, steps, warmup=2 + 2 * attempt)
        counts: dict[str, int] = {}
        for e in on_device:
            counts[e.name] = counts.get(e.name, 0) + 1
        if (sum("logmel_kernel" in e.name for e in on_device) == steps
                and all(c % steps == 0 for c in counts.values())):
            break
        short = {k[:40]: c for k, c in counts.items() if c % steps}
        print(f"  profiler: records short of {steps} calls {short}, tracing again")
    names: dict[str, float] = {}
    for e in on_device:
        names[e.name] = names.get(e.name, 0) + 1 / steps
    return len(on_device) / steps, names


def make_batch(pad_batch, cfg, rows: int, n: int, step: int, seed: int):
    g = np.random.default_rng(seed)
    utts = [(g.standard_normal(n - step * i) * 3000).astype(np.int16) for i in range(rows)]
    return pad_batch(utts, cfg, bucket_len=n, dtype="int16")


def check_features(torch, chain, testing, batch, cfg, feat, mask, atol: float | None,
                   f64_rows: int = 4, atol64: float | None = None) -> None:
    """Features of the card against the CPU chain and, on the first f64_rows
    rows, the float64 chain: max |diff| <= atol (atol64 against float64 when
    given), or with atol None the family's gate of `testing`: the two-regime
    log-mel gate for log-mel features, FAMILY_GATES' (atol, rtol) for PLP,
    spectrogram and SSC."""
    F = feat.shape[1]
    check(tuple(feat.shape) == (batch.audio.shape[0], F, cfg.feat_dim), f"features {tuple(feat.shape)}")
    check(feat.device.type == "cuda" and bool(torch.isfinite(feat).all()), "finite, on the card")
    check(bool((feat[mask == 0] == 0).all()) and int((mask == 0).sum()) > 0,
          f"pad frames exactly 0 ({int((mask == 0).sum())} of {mask.numel()})")

    def gate(got, want, what):
        if atol is None and cfg.features in testing.FAMILY_GATES:
            against = "float64" if "float64" in what else "fp32"
            errs = testing.family_feature_errors(got, want, cfg.features, against)
            print(f"  card vs {what}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
            fails = testing.family_feature_failures(errs, cfg.features, against)
            check(not fails, f"card within the {cfg.features} family's {against} gate of the {what} "
                             f"{fails or ''}")
        elif atol is None:
            errs = testing.logmel_errors(got, want, cfg.log_kind)
            print(f"  card vs {what}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
            fails = testing.logmel_failures(errs)
            check(not fails, f"card within the two-regime log-mel gate of the {what} {fails or ''}")
        else:
            gate_atol = atol64 if atol64 is not None and "float64" in what else atol
            err = float((got.double().cpu() - want.double()).abs().max())
            print(f"  max |card - {what}| = {err:.3e}")
            check(err <= gate_atol, f"card within {gate_atol} of the {what}")

    cpu_feat, cpu_mask = chain.extract_batch(batch.audio, batch.lengths, cfg, device="cpu")
    check(torch.equal(mask.cpu(), cpu_mask), "frame mask equal to the CPU chain's")
    gate(feat.cpu(), cpu_feat, "CPU chain")
    del cpu_feat
    f64, _ = chain.extract_batch(batch.audio[:f64_rows], batch.lengths[:f64_rows],
                                 cfg.replace(dtype="float64"), device="cpu")
    gate(feat[:f64_rows].cpu(), f64, f"float64 chain (rows 0-{f64_rows - 1})")


def step_times(torch, chain, batch, audio, lengths, cfg, what: str, tag: str,
               seconds: float = SECONDS) -> tuple[float, float]:
    """extract_batch step on device-resident rows (CUDA events) and host-fed
    (numpy rows in, host clock), and a profiled step; a row holds `seconds`
    of audio. Returns (step ms, ms of the front-end kernel in the profiled
    step)."""
    rows = audio.shape[0]
    e2e_ms = cuda_ms(torch, lambda: chain.extract_batch(audio, lengths, cfg), reps=10)
    fed_ms = host_ms(torch, lambda: chain.extract_batch(batch.audio, batch.lengths, cfg))
    per_step, busy_ms, ours_ms, tail_ms = profile_step(
        torch, lambda: chain.extract_batch(audio, lengths, cfg), "logmel_kernel")
    shown = float("nan") if ours_ms is None else ours_ms
    print(f"  extract_batch, inputs on the card: {e2e_ms:.4f} ms/step = "
          f"{rows * seconds / (e2e_ms / 1e3):.0f} audio-s/s {tag}")
    print(f"  extract_batch, host int16 numpy in (H2D included, host clock): {fed_ms:.3f} ms = "
          f"{rows * seconds / (fed_ms / 1e3):.0f} audio-s/s {tag}")
    print(f"  profiled step: {per_step:.0f} device kernels, device busy {busy_ms:.4f} ms "
          f"({what} {shown:.4f} ms, feature tail {tail_ms:.4f} ms, the rest "
          f"{busy_ms - shown - tail_ms:.4f} ms); "
          f"idle {max(0.0, 1 - busy_ms / e2e_ms) * 100:.1f}% of the {e2e_ms:.4f} ms step {tag}")
    return e2e_ms, ours_ms


def framed_mask(cfg, n: int, F: int) -> np.ndarray:
    """[n] bool: the samples of a row of n samples at the feature rate that
    its F frames read: frame f's L samples from f*S + frame_offset (under
    centered framing each reflected at the row's length; otherwise the
    frames that start before n, cut at n) and, under signal pre-emphasis,
    each sample's x[t-1]. At a hop longer than the frame the rest of the row
    is never read (a 0.2 s hop of 400-sample frames reads 1/8 of it)."""
    from mfcc_tpu_torch.ops import chain

    L, S = cfg.frame_length, cfg.frame_step
    pre = int(cfg.preemph_mode == "signal" and cfg.preemph != 0.0)
    if n <= 0 or F <= 0:
        return np.zeros(max(n, 0), bool)
    if not chain.centered(cfg):
        starts = S * np.arange(min(F, -(-n // S)))
        cover = np.zeros(n + 1, np.int64)
        np.add.at(cover, np.maximum(starts - pre, 0), 1)
        np.add.at(cover, np.minimum(starts + L, n), -1)
        return np.cumsum(cover)[:-1] > 0
    starts = S * np.arange(F)  # from frame_offset
    cover = np.zeros(S * (F - 1) + L + 1, np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, starts + L, -1)
    idx = np.nonzero(np.cumsum(cover)[:-1] > 0)[0] + chain.frame_offset(cfg)
    if cfg.frame_tail == "center":  # chain.reflect_index
        m = np.mod(idx, 2 * n)
        r = np.where(m < n, m, 2 * n - 1 - m)
    else:
        m = np.mod(idx, max(2 * n - 2, 1))
        r = np.where(m < n, m, 2 * n - 2 - m)
    mask = np.zeros(n, bool)
    mask[r] = True
    if pre:
        mask[np.maximum(r - 1, 0)] = True
    return mask


def input_read(cfg, n_in: int, F: int) -> int:
    """Input samples of a row of n_in that the front-end's function reads:
    `framed_mask`'s at the feature rate, or where cfg resamples, the inputs
    x[q - K + 1 .. q] (q = (j*down + half_len) // up) of each framed output j
    (ops/resample.py), within the row."""
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.ops import resample as R

    if not chain.resamples(cfg):
        return int(framed_mask(cfg, n_in, F).sum())
    d = R.polyphase_design(*R.ratio(cfg.input_sample_rate, cfg.sample_rate))
    out = framed_mask(cfg, R.output_length(n_in, cfg.input_sample_rate, cfg.sample_rate), F)
    edge = np.diff(np.concatenate([[0], out.astype(np.int8), [0]]))
    lo, hi = np.nonzero(edge == 1)[0], np.nonzero(edge == -1)[0] - 1  # runs [lo, hi] of outputs
    q = lambda j: (j * d["down"] + d["half_len"]) // d["up"]  # noqa: E731
    cover = np.zeros(n_in + 1, np.int64)
    np.add.at(cover, np.clip(q(lo) - d["K"] + 1, 0, n_in), 1)
    np.add.at(cover, np.clip(q(hi) + 1, 0, n_in), -1)
    return int((np.cumsum(cover)[:-1] > 0).sum())


def frontend_bytes(cfg, frontend, lens_in, B: int, F: int, sample_bytes: int = 2, taps: int = 0) -> int:
    """Bytes the front-end must move: each input sample its frames read
    (`input_read`), the lengths, the [B, F, M+1] prefix and the window, the
    packed mel weights it reads (mel; none for a spectrogram; mel and melf
    for SSC) with their offsets and band starts, the twiddle and stage
    tables (and a resample's taps), each once."""
    M, N, tables = cfg.n_mels, cfg.n_fft, frontend.mel_matrices(cfg)
    form = frontend.dft_form(cfg)
    tables = (cfg.frame_length + tables * frontend.packed_count(cfg) + (2 * M + 1) * (tables > 0)
              + 2 * frontend.twiddle_count(N, form) + len(frontend.stage_bases(N, form)) + taps)
    samples = sum(input_read(cfg, int(n), F) for n in lens_in)
    return samples * sample_bytes + B * 4 + B * F * (M + 1) * 4 + tables * 4


def family_path(torch, counters, name: str, seed: int, phase: int, tag: str) -> tuple[str, dict]:
    """One PLP, spectrogram or SSC path at b64 x 10 s: the feature kind's
    branch against its plain version, bitwise invariances, extract_batch
    counted and gated, times. Returns (kind, its KERNELS line numbers)."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    cfg = named_config(name)
    kind = frontend.feature_kind(cfg)
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 571, seed=seed)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    branches = {kind: 1, **({"conditioning": 1} if chain.needs_conditioning(cfg) else {})}
    print(f"== {phase}. path {name} b{B} x {SECONDS} s int16 [{B}, {T}], {F} frames, {kind} kind, "
          f"{frontend.smem_bytes(cfg)} B of shared memory a block")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the kernel", frontend=1, **branches)
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs = check_prefix(testing, got, plain, cfg, f"{kind} branch, main batch")
    del plain
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, seed), lengths, cfg)),
          "garbage past each length leaves the output unchanged")
    del got

    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1, **branches)
    check_features(torch, chain, testing, batch, cfg, feat, mask, None)
    del feat, mask

    print(f"  times {tag}")
    kernel_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=10)
    st = chain.logmel_stages(audio, lengths, cfg)
    framed = torch.nn.functional.pad(st["windowed"].reshape(B * F, -1),
                                     (0, cfg.n_fft - cfg.frame_length)).contiguous()
    del st
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
    del framed
    lens = np.minimum(batch.lengths.astype(np.int64), T)
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, B, F),
                               frontend_ops(cfg, chain, frontend, torch, lens, F))
    print(f"  frontend kernel, {kind} kind: {kernel_ms:.4f} ms "
          f"({bound_ms / kernel_ms * 100:.1f}% of bound) {tag}")
    print(f"  plain version (torch rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  torch.fft.rfft on [{B * F}, {cfg.n_fft}] pre-framed (DFT only): {rfft_ms:.4f} ms {tag}")
    step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag)
    return kind, dict(
        launches=launches[kind], max_abs_err=errs["max_abs"], ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms,
    )


def fused_and_split(torch, frontend, R, cfg, audio, lengths, reps: int = 20) -> tuple[float, float]:
    """The fused resample kernel and the two-launch split (resample.cu on
    the rows in float32, converted before the timing, then the plain form on
    its 16 kHz rows), each by `cuda_ms`, in turns (fused, split, split,
    fused); the means of each pair."""
    sr_in = cfg.input_sample_rate
    x = audio.float()
    lens16 = R.output_lengths(lengths, sr_in, cfg.sample_rate)
    cfg16 = cfg.replace(input_sample_rate=None)

    def split():
        frontend.logmel_prefix(R.resample_batch(x, sr_in, cfg.sample_rate), lens16, cfg16)

    fused = lambda: frontend.logmel_prefix(audio, lengths, cfg)  # noqa: E731
    runs = [cuda_ms(torch, fn, reps=reps) for fn in (fused, split, split, fused)]
    print(f"  in turns: fused {runs[0]:.4f}, split {runs[1]:.4f}, split {runs[2]:.4f}, fused {runs[3]:.4f} ms")
    return (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2


def kernel_times(torch, chain, frontend, cfg, audio, lengths, F: int,
                 plain_reps: int = 10) -> tuple[float, float, float]:
    """(kernel ms, plain version ms, torch.fft.rfft(n=n_fft) ms on the
    pre-framed windowed frames [B*F, L]: the DFT only) at cfg's shapes."""
    kernel_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg),
                       reps=plain_reps)
    st = chain.logmel_stages(audio, lengths, cfg)
    framed = st["windowed"].reshape(audio.shape[0] * F, -1).contiguous()
    del st
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
    return kernel_ms, plain_ms, rfft_ms


def check_prefix64(testing, frontend, got, audio, lengths, cfg, what: str,
                   chunk: int | None = None, extra: dict | None = None) -> dict[str, float]:
    """The kernel against the plain version computed in float64 on the CPU
    over every row, `chunk` rows at a time (all at once by default), (the
    gate: at these sizes the fp32 plain version is itself ~2e-5 from
    float64 on loud bins of narrow filters; the card's float64 rfft at odd
    sizes such as 551 is itself wrong), with the fp32 plain version's errors
    on the card printed beside. whisper80's narrow lanes (filters of at most
    two weights) take the per-bin gate (`testing.narrow_lanes`). `extra`
    maps a name to another output of the same rows, each held to the same
    float64 version, its errors put back in its place."""
    import torch

    narrow = None
    if cfg.logmel_norm == "whisper":
        from mfcc_tpu_torch.ops import constants

        narrow = testing.narrow_lanes(constants.chain_constants(cfg)["mel"])
        print(f"  {int(narrow.sum())} of {cfg.n_mels} lanes narrow (at most "
              f"{testing.NARROW_WEIGHTS} weights): the per-bin gate")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs32 = testing.prefix_errors(got, plain, cfg.n_mels, cfg.log_kind, cfg.features, narrow)
    del plain
    print(f"  {what}, kernel vs the fp32 plain version: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs32.items()))
    n, chunk, cfg64 = audio.shape[0], chunk or audio.shape[0], cfg.replace(dtype="float64")
    plain64 = torch.cat([frontend.logmel_prefix_reference(audio[i:i + chunk].cpu(), lengths[i:i + chunk].cpu(),
                                                          cfg64) for i in range(0, n, chunk)])
    for name, other in (extra or {}).items():
        extra[name] = check_prefix(testing, other, plain64, cfg, f"{what}, {name}, vs the float64 plain version",
                                   narrow)
    return check_prefix(testing, got, plain64, cfg, f"{what}, vs the float64 plain version", narrow)


def pcm_batch(pad_batch, cfg, lengths, bucket: int, seed: int):
    g = np.random.default_rng(seed)
    utts = [(g.standard_normal(n) * 3000).astype(np.int16) for n in lengths]
    return pad_batch(utts, cfg, bucket_len=bucket, dtype="int16")


def whisper_gate(testing, got, want, atol: float, what: str) -> None:
    """whisper80 features (rtol 0) within atol, the two-regime errors printed."""
    err = float((got.double().cpu() - want.double()).abs().max())
    errs = testing.whisper_feature_errors(got.cpu(), want)
    print(f"  max |card - {what}| = {err:.3e}; two-regime: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    check(err <= atol, f"card within {atol} of the {what}")


def whisper_path(torch, counters, tag: str) -> dict:
    """whisper80 at b64 x 30 s int16 [64, 480,000], every row Whisper's
    padded 30 s chunk (its last frame reads past the end and reflects): the
    kernel's centered staging, Stockham 400-point FFT and log10_floor against
    the float64 plain version; extract_batch counted, [64, 3000, 80] within
    5e-5 of the CPU chain and 1e-5 of the float64 chain; times."""
    import types

    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain

    cfg = named_config("whisper80")
    n = cfg.sample_rate * WHISPER_SECONDS
    pcm = (np.random.default_rng(16).standard_normal((B, n)) * 3000).astype(np.int16)
    lens = np.full(B, n, np.int32)
    F, M = cfg.num_frames(n), cfg.n_mels
    audio = torch.as_tensor(pcm, device="cuda")
    lengths = torch.as_tensor(lens, device="cuda")
    print(f"== 12. path whisper80 b{B} x {WHISPER_SECONDS} s int16 [{B}, {n}], {F} frames, n_fft "
          f"{cfg.n_fft} ({frontend.dft_form(cfg)}, radices {frontend.radices(cfg.n_fft)}), "
          f"{frontend.smem_bytes(cfg)} B of shared memory a block")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the kernel", frontend=1, centered=1)
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    errs = check_prefix64(testing, frontend, got, audio, lengths, cfg, "log10_floor, main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    del got
    check_counts(torch, frontend, audio, lengths, cfg, "whisper80")

    counters.zero()
    feat, mask = chain.extract_batch(pcm, lens, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1, centered=1)
    check(tuple(feat.shape) == (B, F, M) and feat.device.type == "cuda"
          and bool(torch.isfinite(feat).all()), f"features {tuple(feat.shape)}, finite, on the card")
    cpu_feat, cpu_mask = chain.extract_batch(pcm, lens, cfg, device="cpu")
    check(torch.equal(mask.cpu(), cpu_mask) and bool((cpu_mask == 1).all()),
          "frame mask equal to the CPU chain's, every frame valid")
    whisper_gate(testing, feat, cpu_feat, testing.WHISPER_ATOL, "CPU chain")
    del cpu_feat
    f64, _ = chain.extract_batch(pcm[:4], lens[:4], cfg.replace(dtype="float64"), device="cpu")
    whisper_gate(testing, feat[:4], f64, testing.WHISPER_ORACLE_ATOL, "float64 chain (rows 0-3)")
    del feat, mask, f64

    print(f"  times {tag}")
    kernel_ms, plain_ms, rfft_ms = kernel_times(torch, chain, frontend, cfg, audio, lengths, F, 5)
    lens64 = lens.astype(np.int64)
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens64, B, F),
                               frontend_ops(cfg, chain, frontend, torch, lens64, F))
    print(f"  frontend kernel, whisper80 (centered, Stockham 400, log10_floor): {kernel_ms:.4f} ms "
          f"({bound_ms / kernel_ms * 100:.1f}% of bound) {tag}")
    print(f"  plain version (torch gather + rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  torch.fft.rfft(n={cfg.n_fft}) on [{B * F}, {cfg.frame_length}] pre-framed "
          f"(DFT only): {rfft_ms:.4f} ms {tag}")
    step_times(torch, chain, types.SimpleNamespace(audio=pcm, lengths=lens), audio, lengths, cfg,
               "front-end kernel", tag, seconds=WHISPER_SECONDS)
    return dict(launches=launches["centered"], max_abs_err=errs["max_abs"], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms)


def small_path(torch, counters, cfg, lengths: list[int], bucket: int, seed: int, what: str,
               atol: float, atol64: float | None = None, prefix64: bool = False):
    """One config at a small batch: the kernel counted against its plain
    version (or the float64 plain version), int16 == float32, two runs and
    dirty tails == clean, bitwise; extract_batch counted, features within
    atol of the CPU chain (atol64 of the float64 chain). Returns (batch,
    rows on the card, the prefix gate's errors, the main path's counts)."""
    from mfcc_tpu_torch import testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    batch = pcm_batch(pad_batch, cfg, lengths, bucket, seed)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths_d = torch.as_tensor(batch.lengths, device="cuda")
    F = cfg.num_frames(batch.audio.shape[1])
    form, (plan, groups) = frontend.dft_form(cfg), frontend.fft_layout(cfg)
    branches = plan_branches(chain, frontend, cfg)
    print(f"   {what}: b{len(lengths)} int16 {list(batch.audio.shape)}, {F} frames, {form} DFT, "
          f"{plan} plan ({groups} frames a block at once), {frontend.smem_bytes(cfg)} B of shared "
          "memory a block")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths_d, cfg)
    torch.cuda.synchronize()
    counters.expect("the kernel", frontend=1, **branches)
    if prefix64:
        errs = check_prefix64(testing, frontend, got, audio, lengths_d, cfg, what)
    else:
        errs = check_prefix(testing, got, frontend.logmel_prefix_reference(audio, lengths_d, cfg),
                            cfg, what)
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths_d, cfg))
          and torch.equal(got, frontend.logmel_prefix(audio, lengths_d, cfg)),
          "int16 rows == float32 rows, and two runs equal, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths_d, seed),
                                                  lengths_d, cfg)),
          "garbage past each length leaves the output unchanged")
    check_counts(torch, frontend, audio, lengths_d, cfg, what)
    del got
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    tail_plan = tail_branches(cfg)
    launches = counters.expect("extract_batch", frontend=1, **branches, **tail_plan)
    check_features(torch, chain, testing, batch, cfg, feat, mask, atol, atol64=atol64)
    return batch, audio, lengths_d, errs, launches


def plan_branches(chain, frontend, cfg) -> dict[str, int]:
    """The front-end's branch counts of one plain-form launch of cfg: its
    framing, form, plan (`frontend.PLAN_TRAITS`: frames, tables, bands,
    rows and sums in device memory), dither and conditioning."""
    form, plan = frontend.dft_form(cfg), frontend.fft_plan(cfg)
    gather, tables = frontend.PLAN_TRAITS.get(plan, (False,) * 5)[:2]
    return {k: 1 for k, on in (
        ("centered", chain.centered(cfg)), ("block_fft", plan != "warp"), ("global_tables", tables),
        ("gather", gather), ("gather_bands", plan == "gather_bands"), ("gather_rows", plan == "gather_rows"),
        ("gather_sums", plan == "gather_sums"), ("cluster", plan == "cluster"), ("wide", plan == "wide"),
        ("bluestein", form == "bluestein"), ("dither", cfg.dither > 0.0),
        ("conditioning", chain.needs_conditioning(cfg))) if on}


def tail_branches(cfg) -> dict[str, int]:
    """The feature tail's launch counts for one mfcc extract_batch of cfg:
    the tail once, its CMVN pass under utterance CMVN, and the split's
    1 + deltas passes where it takes the split, its base kernel past
    tail.CHAIN_LANES filters."""
    from mfcc_tpu_torch.kernels import tail

    if cfg.features != "mfcc":
        return {}
    split = tail.plan(cfg)[0] == "split"
    return {"tail": 1, **({"tail_cmvn": 1} if cfg.cmvn == "utterance" else {}),
            **({"tail_split": 1 + cfg.deltas} if split else {}),
            **({"tail_base": 1} if tail.split_base(cfg) == "stretches" else {})}


def dft_times(torch, chain, frontend, cfg, batch, audio, lengths, what: str, tag: str) -> dict:
    """The kernel's device time (profiler, L2 flushed), CUDA events around
    it, its plain version (events), torch.fft.rfft(n=n_fft) on the same
    windowed frames (device time) and the bound, printed; the KERNELS line's
    numbers but launches and max_abs_err."""
    B, F = audio.shape[0], cfg.num_frames(batch.audio.shape[1])
    event_ms, plain_ms, _ = kernel_times(torch, chain, frontend, cfg, audio, lengths, F)
    kernel_ms = device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg), "logmel_kernel")
    st = chain.logmel_stages(audio, lengths, cfg)
    framed = st["windowed"].reshape(B * F, -1).contiguous()
    del st
    rfft_ms = device_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
    del framed
    lens64 = np.minimum(batch.lengths.astype(np.int64), batch.audio.shape[1])
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens64, B, F),
                               frontend_ops(cfg, chain, frontend, torch, lens64, F))
    plan, groups = frontend.fft_layout(cfg)
    at_once = f"{groups} blocks a frame" if plan == "cluster" else f"{groups} frames a block at once"
    print(f"  frontend kernel, {what} ({frontend.dft_form(cfg)} form, {plan} plan, {at_once}): "
          f"{kernel_ms:.4f} ms of device time, L2 flushed ({bound_ms / kernel_ms * 100:.1f}% "
          f"of bound; {kernel_ms / rfft_ms:.2f}x rfft; {kernel_ms / plain_ms:.3f}x its plain version); "
          f"CUDA events {event_ms:.4f} ms {tag}")
    print(f"  plain version: {plain_ms:.4f} ms (events); torch.fft.rfft(n={cfg.n_fft}) on "
          f"[{B * F}, {cfg.frame_length}] (DFT only): {rfft_ms:.4f} ms of device time {tag}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms)


def bluestein_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 15: the Bluestein form at classic13 n_fft 404 and 551 (odd),
    b16 x 10 s: `small_path` (the kernel counted against the float64 plain
    version computed on the CPU, the bitwise invariances, extract_batch
    counted, features within 5e-4 of the CPU chain and the float64 chain);
    fused_logmel_stages(dft_passes="fp32") counted, its prefix bitwise the
    default route's; each timed beside rfft(n=n_fft) and its bound. Then
    n_fft 1102 (its warp-plan rows are over the block) through the block
    FFT plan, counted and timed: under its plain version and within 5x
    rfft."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain

    n16 = 16000 * SECONDS
    lens = [n16 - 571 * i for i in range(B_SMALL)]
    print(f"== 15. the Bluestein FFT: classic13 n_fft 404 and 551, b{B_SMALL} x {SECONDS} s; "
          "the block FFT plan at 1102")
    for n_fft, seed, key in ((404, 21, "bluestein"), (551, 30, None), (1102, 31, "block_fft")):
        cfg = named_config("classic13").replace(n_fft=n_fft)
        form, plan = frontend.dft_form(cfg), frontend.fft_plan(cfg)
        check(form == "bluestein" and (plan == "warp") == (n_fft != 1102),
              f"n_fft {n_fft} takes the {form} form in the {plan} plan")
        q, k, P = frontend.bluestein_dims(n_fft)
        print(f"  n_fft {n_fft}: Q {q} points, K {k} outputs, P {P} = "
              f"{'*'.join(map(str, frontend.radices(2 * P)))}, {frontend.smem_bytes(cfg)} B a block")
        batch, audio, lengths, errs, launches = small_path(
            torch, counters, cfg, lens, n16, seed, f"classic13 n_fft {n_fft}", testing.FEATURE_ATOL,
            prefix64=True)
        counters.zero()
        st = frontend.fused_logmel_stages(audio, lengths, cfg, dft_passes="fp32")
        torch.cuda.synchronize()
        counters.expect("fused_logmel_stages(dft_passes='fp32')", frontend=1, bluestein=1,
                        **({"block_fft": 1} if plan != "warp" else {}))
        check(torch.equal(st["prefix"], frontend.logmel_prefix(audio, lengths, cfg)),
              "the fp32 route's prefix == the default route's, bitwise")
        if n_fft == 551:
            # cuFFT's own rfft at this size, beside the float64 product
            # chain.power_spectrum takes on the card instead
            st = chain.logmel_stages(audio, lengths, cfg)
            got = torch.fft.rfft(st["windowed"], n=n_fft, dim=-1).cpu().to(torch.complex128)
            want = torch.fft.rfft(st["windowed"].cpu().double(), n=n_fft, dim=-1)
            rel = (got - want).abs().amax(-1) / want.abs().amax(-1).clamp(min=1.0)
            print(f"  torch.fft.rfft(n=551) on the card vs float64 on the CPU: max |diff| / frame max "
                  f"{float(rel.max()):.3e}, {int((rel > 1e-3).sum())} frames over 1e-3 (the plain chain "
                  f"on the card takes the float64 DFT product at this size)")
            del st, got, want
        if key is None:
            continue
        times = dft_times(torch, chain, frontend, cfg, batch, audio, lengths, f"n_fft {n_fft}", tag)
        results[key] = dict(launches=launches[key], max_abs_err=errs["max_abs"], **times)
        if key == "block_fft":
            check(times["ms"] < times["plain_ms"], "the block FFT plan under its plain version's time")
            check(times["ms"] < 5 * times["library_ms"], "the block FFT plan within 5x rfft(n=1102)")
        if n_fft == 404:
            r2_ms = device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg.replace(n_fft=512)),
                              "logmel_kernel")
            print(f"  the same rows at n_fft 512 (Stockham 8*8*4): {r2_ms:.4f} ms of device time {tag}")
        del audio, lengths


def large_n_fft_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 27: the n_fft sizes the warp plan refused, through the block
    FFT plan: librosa's framing (logmel80 at 22.05 kHz, n_fft 2048, hop 512,
    128 mels) at b64 x 10 s int16 through extract_batch (one front-end
    launch, counted) against the float64 plain version, the CPU chain and
    the float64 chain; classic13_deltas at n_fft 4096 (Stockham) and 2501
    (Bluestein, its tables in device memory) at b16 through the kernels
    (`small_path`, the front-end and the tail counted); one block launch at
    librosa's framing against the offline prefix on its valid frames; each
    timed beside its plain version, rfft(n=n_fft) and its bound."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    cfg = named_config("logmel80").replace(**LIBROSA)
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 571, seed=27)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    plan, groups = frontend.fft_layout(cfg)
    print(f"== 27. the block FFT plan: librosa's framing (22.05 kHz, n_fft 2048, frames of 2048, hop 512, "
          f"128 mels) b{B} x {SECONDS} s int16 [{B}, {T}], {F} frames, {plan} plan ({groups} frames a "
          f"block at once), {frontend.smem_bytes(cfg)} B a block (the warp plan's "
          f"{frontend._fft_smem(cfg, 'stockham', 'warp'):,} B)")
    check(plan == "block" and chain.unsupported_reason(cfg) is None, "librosa's framing takes the block plan")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the kernel", frontend=1, block_fft=1)
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    errs = check_prefix64(testing, frontend, got, audio, lengths, cfg, "librosa's framing, main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
          and torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg)),
          "int16 rows == float32 rows, and two runs equal, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 27), lengths, cfg)),
          "garbage past each length leaves the output unchanged")
    check_counts(torch, frontend, audio, lengths, cfg, "librosa's framing")
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1, block_fft=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, None)
    del feat, mask

    # one block launch (row origin 1) over frames [f0, f0 + K) of row 0
    # against the offline prefix on its valid frames
    K, S, L = 40, cfg.frame_step, cfg.frame_length
    f0 = 100
    span = (K - 1) * S + L
    t0 = f0 * S
    rows = audio[:1, t0 - 1 : t0 + span].float().contiguous()
    valid = torch.tensor([min(int(batch.lengths[0]) - t0, span)], dtype=torch.int32, device="cuda")
    counters.zero()
    blk = frontend.logmel_block(rows, valid, cfg)
    torch.cuda.synchronize()
    counters.expect("the block launch", block=1, block_fft=1)
    nv = int(chain.num_valid_frames(valid, cfg)[0])
    check_prefix(testing, blk[:, :nv], got[:1, f0 : f0 + nv], cfg,
                 f"block launch at frames [{f0}, {f0 + K}) vs the offline prefix ({nv} valid)")
    del got

    print(f"  times {tag}")
    times = dft_times(torch, chain, frontend, cfg, batch, audio, lengths, "librosa's framing", tag)
    results["block_fft_librosa"] = dict(launches=launches["block_fft"], max_abs_err=errs["max_abs"], **times)
    step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag)
    del audio, lengths

    n16 = 16000 * SECONDS
    lens = [n16 - 571 * i for i in range(B_SMALL)]
    for n_fft, seed, key in ((4096, 271, "block_fft_4096"), (2501, 272, "block_fft_2501")):
        cfg = named_config("classic13_deltas").replace(n_fft=n_fft)
        print(f"   classic13_deltas n_fft {n_fft}: warp plan {frontend._fft_smem(cfg, frontend.dft_form(cfg), 'warp'):,} B")
        batch, audio, lengths, errs, launches = small_path(
            torch, counters, cfg, lens, n16, seed, f"classic13_deltas n_fft {n_fft}", testing.FEATURE_ATOL,
            prefix64=True)
        check(launches["block_fft"] == 1 and launches["tail"] == 1, "the block plan and the tail, once each")
        times = dft_times(torch, chain, frontend, cfg, batch, audio, lengths, f"n_fft {n_fft}", tag)
        results[key] = dict(launches=launches["block_fft"], max_abs_err=errs["max_abs"], **times)
        del audio, lengths
    print(f"  phase 27 took {time.perf_counter() - t_phase:.1f} s")


# librosa's melspectrogram at n_fft 8192 (win_length n_fft, hop_length
# win_length // 4 = 2048, 128 mels, sr 22,050) and a 44.1 kHz framing of
# 4096 at hop 2048, logmel80 overrides
LIBROSA_8192 = dict(sample_rate=22050, n_fft=8192, win_len_s=8192 / 22050, hop_s=2048 / 22050, n_mels=128)
K44_4096 = dict(sample_rate=44100, n_fft=4096, win_len_s=4096 / 44100, hop_s=2048 / 44100, n_mels=128)
LONG_SPAN_SECONDS = 30  # librosa's 8192-point framing: rows of 30 s at full width
# the tail at wide cepstra: (key, overrides, the batch's seed, the card's
# features' gate against the float64 chain on rows 0-3 of that batch). On
# the H100 the card read 2.59 (170 filters; row 3, frame 880, where filter
# 1's DC power is roundoff) and 2.56e-2 (200), the CPU fp32 chain 20.6 and
# 2.56e-2 on the same rows: each gate is about 2.3 times the card's reading.
TAIL_WIDE = (("tail_split_170", dict(n_mels=170, n_ceps=170, delta_window=8), 1556, 6.0),
             ("tail_split_200", dict(n_mels=200, n_ceps=200, delta_window=40), 1077, 6e-2))


def long_span_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 28: every hop and frame length, and the feature tail at wide
    cepstra and delta windows. (28.1) librosa's melspectrogram(n_fft=8192)
    framing (22.05 kHz, 8192-sample frames, hop 2048, 128 mels) at b64 x 30 s
    int16 through the gather plan: the kernel against the float64 plain
    version, int16 == float32, two runs and dirty tails bitwise, the counts
    and mask, extract_batch counted within the two-regime log-mel gate of the
    CPU chain and the float64 chain; timed (device time, events, plain,
    rfft(n=8192), bound, the extract_batch step with its device kernels and
    idle share). (28.2) at b16 through `small_path` (the kernel counted
    against its plain version, the bitwise invariances, extract_batch
    counted and gated) and timed: classic13_deltas at a 0.2 s hop and with
    3 s frames, kaldi_mfcc with dither at 0.25 s, whisper80 at 0.2 s, n_fft
    4096 at hop 2048 at 44.1 kHz, n_fft 6001 (Bluestein, tables in device
    memory); whisper80 fed 48 kHz at 0.2 s (the split route) counted and
    gated. (28.3) the block launch at a 0.2 s hop, bitwise the offline
    prefix on its valid frames. (28.4) the feature tail in its split plan
    at 170 cepstra and delta window 8 and at 200 and window 40, b16,
    counted through extract_batch (each of the split's passes), bitwise the
    tail on the front-end's own prefix, against its plain version there at
    the tail's gate; the prefix against the float64 plain version; the
    features of rows 0-3 against the float64 chain, the card's gated and
    the CPU chain's printed beside them; timed."""
    import types

    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend, tail
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.ops import resample as R
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    # 28.1 librosa's 8192-point framing at full width
    cfg = named_config("logmel80").replace(**LIBROSA_8192)
    n = cfg.sample_rate * LONG_SPAN_SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 5711, seed=28)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    plan, groups = frontend.fft_layout(cfg)
    print(f"== 28. every hop and frame length: librosa's melspectrogram(n_fft=8192) framing (22.05 kHz, "
          f"frames of 8192, hop 2048, 128 mels) b{B} x {LONG_SPAN_SECONDS} s int16 [{B}, {T}], {F} frames, "
          f"{plan} plan ({groups} frames a block at once), {frontend.smem_bytes(cfg):,} B a block (the "
          f"staged block plan's {frontend._fft_smem(cfg, 'stockham', 'block', True, 1):,} B)")
    check(plan == "gather" and chain.unsupported_reason(cfg) is None, "librosa's 8192 framing takes the gather plan")
    for c in (cfg, named_config("classic13_deltas").replace(hop_s=0.2),
              named_config("kaldi_mfcc").replace(dither=1.0, hop_s=0.25)):
        info = frontend.kernel_info(c)
        print(f"    the gather plan {frontend.fft_layout(c)}, n_fft {c.n_fft}, hop {c.frame_step}: {info}")
        check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, "no spills, launchable")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the kernel", frontend=1, block_fft=1, gather=1)
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    errs = check_prefix64(testing, frontend, got, audio, lengths, cfg, "librosa's 8192 framing, main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
          and torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg)),
          "int16 rows == float32 rows, and two runs equal, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 28), lengths, cfg)),
          "garbage past each length leaves the output unchanged")
    del got
    check_counts(torch, frontend, audio, lengths, cfg, "librosa's 8192 framing")
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1, block_fft=1, gather=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, None)
    del feat, mask
    print(f"  times {tag}")
    times = dft_times(torch, chain, frontend, cfg, batch, audio, lengths, "librosa's 8192 framing", tag)
    results["gather_librosa_8192"] = dict(launches=launches["gather"], max_abs_err=errs["max_abs"], **times)
    step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag, seconds=LONG_SPAN_SECONDS)
    del audio, lengths

    # 28.2 the other framings at b16: (key, config, overrides, the features'
    # gate against the CPU chain and against float64, the float64 plain version)
    for key, name, over, atol, atol64, prefix64 in (
        ("gather_hop", "classic13_deltas", dict(hop_s=0.2), testing.FEATURE_ATOL, None, False),
        ("gather_long_frames", "classic13_deltas", dict(win_len_s=3.0), testing.FEATURE_ATOL, None, False),
        ("gather_conditioning_dither", "kaldi_mfcc", dict(dither=1.0, hop_s=0.25), testing.KALDI_MFCC_ATOL,
         None, False),
        ("gather_centered", "whisper80", dict(hop_s=0.2), testing.WHISPER_ATOL, testing.WHISPER_ORACLE_ATOL,
         True),
        ("gather_44k_4096", "logmel80", K44_4096, None, None, True),
        ("gather_bluestein_6001", "classic13_deltas", dict(n_fft=6001), testing.FEATURE_ATOL, None, True),
    ):
        cfg = named_config(name).replace(**over)
        n = cfg.sample_rate * SECONDS
        lens = [n - 571 * i for i in range(B_SMALL - 2)] + [min(n, 3 * cfg.frame_length // 2), 1]
        print(f"   {key}: {name} {over}: {frontend.fft_layout(cfg)}, the staged block plan's "
              f"{frontend._fft_smem(cfg, frontend.dft_form(cfg), 'block', True, 1):,} B")
        batch, audio, lengths, errs, launches = small_path(
            torch, counters, cfg, lens, n, sum(map(ord, key)), f"{name} {over}", atol, atol64,
            prefix64=prefix64)
        check(launches["gather"] == 1, "the gather plan, once")
        times = dft_times(torch, chain, frontend, cfg, batch, audio, lengths, key, tag)
        results[key] = dict(launches=launches["gather"], max_abs_err=errs["max_abs"], **times)
        del audio, lengths

    # whisper80 fed 48 kHz at a 0.2 s hop: the split route, then the gather plan
    cfg = named_config("whisper80").replace(input_sample_rate=48000, hop_s=0.2)
    sr_in = cfg.input_sample_rate
    n = sr_in * SECONDS
    g = np.random.default_rng(282)
    pcm = (g.standard_normal((B_SMALL, n)) * 3000).astype(np.int16)
    lens = np.array([n - 1713 * i for i in range(B_SMALL)], np.int32)
    pcm[np.arange(n)[None, :] >= lens[:, None]] = 0
    audio = torch.as_tensor(pcm, device="cuda")
    lengths = torch.as_tensor(lens, device="cuda")
    F = cfg.num_frames(R.output_length(n, sr_in, cfg.sample_rate))
    print(f"   whisper80 fed 48 kHz at a 0.2 s hop, b{B_SMALL} x {SECONDS} s: route "
          f"{frontend.resample_route(cfg)}, {frontend.fft_layout(frontend.feature_rate_config(cfg))} at 16 kHz")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("the split route", resample=1, frontend=1, centered=1, split=1,
                               block_fft=1, gather=1)
    errs = check_prefix64(testing, frontend, got, audio, lengths, cfg, "whisper80 fed 48 kHz, hop 0.2 s")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == float32 rows, bitwise")
    del got
    counters.zero()
    feat, mask = chain.extract_batch(pcm, lens, cfg)
    torch.cuda.synchronize()
    counters.expect("extract_batch", resample=1, frontend=1, centered=1, split=1, block_fft=1, gather=1)
    cpu_feat, cpu_mask = chain.extract_batch(pcm, lens, cfg, device="cpu")
    check(torch.equal(mask.cpu(), cpu_mask), "frame mask equal to the CPU chain's")
    whisper_gate(testing, feat, cpu_feat, testing.WHISPER_ATOL, "CPU chain")
    f64, _ = chain.extract_batch(pcm[:4], lens[:4], cfg.replace(dtype="float64"), device="cpu")
    whisper_gate(testing, feat[:4], f64, testing.WHISPER_ORACLE_ATOL, "float64 chain (rows 0-3)")
    del feat, mask, cpu_feat, f64
    event_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    route_ms = device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))  # both kernels
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=5)
    d = R.polyphase_design(*R.ratio(sr_in, cfg.sample_rate))
    conv_ms = device_ms(torch, conv1d_resample(torch, audio.float(), d))
    st = chain.logmel_stages(*chain.resample_input(audio, lengths, cfg), cfg)
    framed = st["windowed"].reshape(-1, cfg.frame_length).contiguous()
    del st
    rfft_ms = device_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
    del framed
    lens16 = np.array([R.output_length(int(x), sr_in, cfg.sample_rate) for x in lens])
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, B_SMALL, F, taps=d["up"] * d["K"]),
                               frontend_ops(cfg, chain, frontend, torch, lens16, F)
                               + resample_ops(R, d["up"], d["down"], lens16, cfg, F))
    print(f"  the split route (resample.cu, then the gather plan): {route_ms:.4f} ms of device time "
          f"({bound_ms / route_ms * 100:.1f}% of bound); CUDA events {event_ms:.4f} ms; plain {plain_ms:.4f} "
          f"ms; library: conv1d stride {d['down']} {conv_ms:.4f} + rfft(n={cfg.n_fft}) {rfft_ms:.4f} ms "
          f"of device time {tag}")
    results["gather_split_48k"] = dict(launches=launches["gather"], max_abs_err=errs["max_abs"], ms=route_ms,
                                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=conv_ms + rfft_ms)
    del audio, lengths

    # 28.3 the block launch at a 0.2 s hop against the offline prefix
    cfg = named_config("classic13_deltas").replace(hop_s=0.2)
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, 1, n, 0, seed=283)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    offline = frontend.logmel_prefix(audio, lengths, cfg)
    K, S, L, f0 = 16, cfg.frame_step, cfg.frame_length, 7
    span = (K - 1) * S + L
    rows = audio[:, f0 * S - 1 : f0 * S + span].float().contiguous()
    valid = torch.tensor([min(int(batch.lengths[0]) - f0 * S, span)], dtype=torch.int32, device="cuda")
    counters.zero()
    blk = frontend.logmel_block(rows, valid, cfg)
    torch.cuda.synchronize()
    counters.expect("the block launch", block=1, block_fft=1, gather=1)
    nv = int(chain.num_valid_frames(valid, cfg)[0])
    check(nv >= 1 and torch.equal(blk[:, :nv], offline[:, f0 : f0 + nv]),
          f"the block launch at a 0.2 s hop, frames [{f0}, {f0 + K}) ({nv} valid), == the offline prefix, "
          "bitwise")
    del audio, lengths

    # 28.4 the feature tail at wide cepstra and delta windows. 170 or 200
    # filters at n_fft 512 are mostly one or two bins wide (29 of 170 empty,
    # 82 of one or two weights), and filter 1 weighs the DC bin alone: where
    # a frame's windowed sum is near 0, its fp32 power is roundoff (exactly 0
    # in one fp32 chain, 1e-9 in the other) and its log moves by up to tens,
    # which the DCT and lifter carry into every cepstrum. The front-end is
    # held to the float64 plain version at the prefix gates, those lanes per
    # bin (`testing.narrow_lanes`), and the tail to its plain version on the
    # same prefix; the features of rows 0-3, of the card and of the CPU
    # chain, each against the float64 chain, the card's at `f64_gate`.
    n16 = 16000 * SECONDS
    lens = [n16 - 571 * i for i in range(B_SMALL - 2)] + [401, 0]
    for key, over, seed, f64_gate in TAIL_WIDE:
        cfg = named_config("classic13_deltas").replace(**over)
        mode = tail.plan(cfg)[0]
        print(f"   {key}: classic13_deltas {over}: the tail's plan {tail.plan(cfg)}")
        batch = pcm_batch(pad_batch, cfg, lens, n16, seed)
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        counters.zero()
        feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
        torch.cuda.synchronize()
        launches = counters.expect("extract_batch", frontend=1, **tail_branches(cfg))
        check(mode == "split", f"the tail's {mode} plan")
        prefix, nv, _ = frontend.logmel_prefix_counts(audio, lengths, cfg)
        mel = chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"]
        plain64 = frontend.logmel_prefix_reference(audio.cpu(), lengths.cpu(), cfg.replace(dtype="float64"))
        check_prefix(testing, prefix, plain64, cfg, f"{cfg.n_mels} filters vs the float64 plain version",
                     narrow=testing.narrow_lanes(mel))
        del plain64
        got = tail.feature_tail(prefix, nv, cfg)
        check(torch.equal(got, feat), "extract_batch's features == the tail kernel's on the front-end's prefix, "
                                      "bitwise")
        want = tail.feature_tail_reference(prefix, nv, cfg)
        errs = testing.tail_errors(got, want)
        print("  the tail vs its plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        check(not testing.tail_failures(errs), "the tail within max(2e-4, 2e-5 max|f|) of its plain version")
        check(torch.equal(got, tail.feature_tail(prefix, nv, cfg)), "two runs equal, bitwise")
        cpu_feat, cpu_mask = chain.extract_batch(batch.audio, batch.lengths, cfg, device="cpu")
        check(torch.equal(mask.cpu(), cpu_mask) and bool((feat[mask == 0] == 0).all())
              and bool(torch.isfinite(feat).all()), "mask equal to the CPU chain's, finite, pad rows exactly 0")
        f64, _ = chain.extract_batch(batch.audio[:4], batch.lengths[:4], cfg.replace(dtype="float64"),
                                     device="cpu")
        card64 = (feat[:4].cpu().double() - f64).abs()
        cpu64 = float((cpu_feat[:4].double() - f64).abs().max())
        at = np.unravel_index(int(card64.argmax()), tuple(card64.shape))
        print(f"  rows 0-3 against the float64 chain: card {float(card64.max()):.4e} (at row, frame, column "
              f"{tuple(int(i) for i in at)}), CPU chain {cpu64:.4e}; card vs the CPU chain on all rows "
              f"{float((feat.cpu() - cpu_feat).abs().max()):.4e} (max |f| {float(f64.abs().max()):.1f})")
        check(float(card64.max()) < f64_gate, f"the card's features within {f64_gate} of the float64 chain "
                                               "(rows 0-3)")
        del feat, mask, cpu_feat, got, want, f64, card64
        substr = None  # the split's passes
        kernel_ms = device_ms(torch, lambda: tail.feature_tail(prefix, nv, cfg), substr)
        plain_ms = cuda_ms(torch, lambda: tail.feature_tail_reference(prefix, nv, cfg), reps=10)
        bound_ms, bound_by = tail_bound(cfg, B_SMALL, prefix.shape[1], int(nv.sum()))
        print(f"  feature tail, {mode} plan: {kernel_ms:.4f} ms of device time, L2 flushed "
              f"({bound_ms / kernel_ms * 100:.1f}% of bound); plain version {plain_ms:.4f} ms {tag}")
        print("  library: none (no single PyTorch call computes the cepstral tail)")
        results[key] = dict(launches=launches["tail_split"], max_abs_err=errs["max_abs"], ms=kernel_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del audio, lengths, prefix
    print(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s")


# librosa's melspectrogram at 44.1 kHz and n_fft 16384 (win_length n_fft,
# hop_length 4096, 128 Slaney filters from 0 Hz to Nyquist), a logmel80
# override; phase 29's sizes past the gather plan's layouts: (case, config,
# overrides, rows, seconds a row, the cluster plan's blocks a frame, the
# parent's plan (the ladder without the cluster plan), rows of the float64
# chain's check). The ladder takes the cluster plan at Stockham FFTs of
# 8,192 points or more and Bluestein FFTs of P = 16,384 or more
# (frontend.CLUSTER_MIN_POINTS), else the parent's; the other is forced
# beside it. Entries "cluster_<case>" and "<parent plan>_<case>" of the
# kernels line.
LIBROSA_16384 = dict(sample_rate=44100, n_fft=16384, win_len_s=16384 / 44100, hop_s=4096 / 44100, n_mels=128,
                     mel_variant="librosa_hz", mel_scale="slaney", mel_norm="slaney", mel_low_hz=0.0,
                     mel_high_hz=22050.0)
ANY_NFFT = (
    ("librosa_44k_16384", "logmel80", LIBROSA_16384, B, 30, 2, "gather_bands", 2),
    ("bluestein_7001", "classic13_deltas", dict(n_fft=7001), B_SMALL, 10, 2, "gather_bands", 2),
    ("bluestein_12502", "classic13_deltas", dict(n_fft=12502), B_SMALL, 10, 2, "gather_bands", 2),
    ("whisper80_16384", "whisper80", dict(n_fft=16384), B_SMALL, 10, 2, "gather_bands", 2),
    ("bluestein_13001", "classic13_deltas", dict(n_fft=13001), B_SMALL, 10, 2, "gather_rows", 2),
    ("32768", "classic13_deltas", dict(n_fft=32768), B_SMALL, 10, 2, "gather_rows", 2),
    ("48k_65536", "classic13_deltas", dict(sample_rate=48000, n_fft=65536), 4, 30, 4, "gather_rows", 1),
    ("131072", "classic13_deltas", dict(n_fft=131072), 2, 30, 8, "gather_rows", 1),
)
# the case where every other cluster size is forced once
FORCED_CLUSTERS_AT = "32768"


def without_cluster(frontend):
    """frontend.fft_layout without the cluster plan: the ladder of the
    parent (every other plan), for a forced launch."""
    own = frontend.fft_layout
    return lambda cfg, form=None, int16=True, cluster=True: own(cfg, form, int16, False)


def without_wide(frontend):
    """frontend.fft_layout without the wide plan: the plan it replaced
    ("gather_bands", "gather_rows" or "gather_sums"), for a forced launch."""
    own = frontend.fft_layout
    return lambda cfg, form=None, int16=True, cluster=True, wide=True: own(cfg, form, int16, cluster, False)


def forced_layout(frontend, layout):
    """A runner of fn under the layout mirror (frontend.fft_layout) forced
    to `layout` (a layout, or a mirror), the mirror put back after."""
    def run(fn):
        own = frontend.fft_layout
        frontend.fft_layout = layout if callable(layout) else (lambda *a, **k: layout)
        try:
            return fn()
        finally:
            frontend.fft_layout = own
    return run


def any_n_fft_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 29: every n_fft past the gather plan's layouts, in the ladder's
    plan and beside it the other forced: the cluster plan (each frame's FFT
    rows over a thread-block cluster's shared memory: 2, 4 or 8 blocks a
    frame; the ladder's at frontend.CLUSTER_MIN_POINTS) and the parent's plans
    without it, "gather_bands" (the packed mel bands read from device
    memory) and "gather_rows" (each group's FFT rows in a workspace in
    device memory). librosa's melspectrogram(sr=44100, n_fft=16384,
    hop_length=4096, n_mels=128) framing at b64 x 30 s int16;
    classic13_deltas at n_fft 7,001, 12,502 and 13,001 (Bluestein), 32,768
    and whisper80 at 16,384, b16 x 10 s; classic13_deltas at 48 kHz and
    n_fft 65,536, b4 x 30 s; at 131,072, b2 x 30 s. For each: the plans and
    the cluster size, the ladder's launch counted by plan against the
    float64 plain version on the CPU on every row at the prefix gates (the
    forced plan too, and at 32,768 the other cluster sizes), the fp32 plain
    version's errors printed; int16 == float32, two runs and dirty tails
    bitwise; a persistent grid of 3 clusters, and for "gather_rows" a
    NaN-filled workspace and a grid of 7 blocks, bitwise; the counts and
    mask; extract_batch counted, its mask the chain's and its features on
    the first rows within the family's gate of the float64 chain; device
    time of both plans in turns (the ladder's, the other, the other, the
    ladder's), events, the plain version, rfft(n=n_fft), the bound and the
    extract_batch step."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    print("== 29. every n_fft: the cluster plan and the parent's plans (bands, then rows, in device memory)")
    own_workspace, own_resident, own_clusters = frontend._workspace, frontend._resident_blocks, frontend._active_clusters
    for case, name, over, rows, seconds, C, parent, rows64 in ANY_NFFT:
        t_case = time.perf_counter()
        cfg = named_config(name).replace(**over)
        n = cfg.sample_rate * seconds
        lens = [n - 571 * i for i in range(rows - 2)] + [min(n, 3 * cfg.frame_length // 2), 1] if rows > 2 \
            else [n - 571 * i for i in range(rows)]
        batch = pcm_batch(pad_batch, cfg, lens, n, sum(map(ord, f"{parent}_{case}")))
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        F = cfg.num_frames(batch.audio.shape[1])
        form, layout = frontend.dft_form(cfg), frontend.fft_layout(cfg)
        taken = frontend.fft_points(cfg.n_fft, form) >= frontend.CLUSTER_MIN_POINTS[form]
        plan, other = ("cluster", parent) if taken else (parent, "cluster")
        key, other_key = f"{plan}_{case}", f"{other}_{case}"
        to_other = forced_layout(frontend, without_cluster(frontend) if taken else ("cluster", C))
        print(f"   {key}: {name} {over} b{rows} x {seconds} s int16 {list(batch.audio.shape)}, {F} frames, "
              f"{form} DFT, {layout} ({frontend.smem_bytes(cfg):,} B a block); the other forced: "
              f"{to_other(lambda: frontend.fft_layout(cfg))}")
        check(layout == (("cluster", C) if taken else frontend.fft_layout(cfg, cluster=False))
              and frontend.fft_layout(cfg, cluster=False)[0] == parent and chain.unsupported_reason(cfg) is None,
              f"{key} takes {plan}, the cluster plan at {C} blocks a frame where it does")
        for run in (lambda fn: fn(), to_other):
            info = run(lambda: frontend.kernel_info(cfg))
            print(f"    {info}")
            check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1 and info.get("clusters", 1) >= 1,
                  "no spills, launchable")
        branches = plan_branches(chain, frontend, cfg)
        counters.zero()
        got = frontend.logmel_prefix(audio, lengths, cfg)
        torch.cuda.synchronize()
        counters.expect("the kernel", frontend=1, **branches)
        check(tuple(got.shape) == (rows, F, cfg.n_mels + 1), f"prefix shape {tuple(got.shape)}")
        # the other plan, forced: its launch counted, its output held to the
        # same float64 version below; the other cluster sizes at one case
        other_branches = to_other(lambda: plan_branches(chain, frontend, cfg))
        counters.zero()
        got_other = to_other(lambda: frontend.logmel_prefix(audio, lengths, cfg))
        torch.cuda.synchronize()
        other_launches = counters.expect(f"{other}, forced", frontend=1, **other_branches)
        extra = {f"{other}, forced": got_other}
        if case == FORCED_CLUSTERS_AT:
            for c in frontend.CLUSTER_SIZES:
                if c != C:
                    extra[f"forced to {c} blocks a cluster"] = forced_layout(frontend, ("cluster", c))(
                        lambda: frontend.logmel_prefix(audio, lengths, cfg))
        # every row (each cluster, and each block's slot of a workspace): the
        # float64 frames of a chunk of rows at most 2 GB
        errs = check_prefix64(testing, frontend, got, audio, lengths, cfg, f"{key}, all {rows} rows",
                              chunk=max(1, 2**28 // (F * cfg.n_fft)), extra=extra)
        other_errs = extra[f"{other}, forced"]
        check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
              and torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg)),
              "int16 rows == float32 rows, and two runs equal, bitwise")
        check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, rows), lengths, cfg)),
              "garbage past each length leaves the output unchanged")
        by_plan = {plan: (got, lambda fn: fn()), other: (got_other, to_other)}
        out_c, run_c = by_plan["cluster"]
        frontend._active_clusters = lambda *args: 3
        try:
            check(torch.equal(out_c, run_c(lambda: frontend.logmel_prefix(audio, lengths, cfg))),
                  "the cluster plan: a persistent grid of 3 clusters (each over many frames), bitwise")
        finally:
            frontend._active_clusters = own_clusters
        if parent == "gather_rows":
            out_r, run_r = by_plan["gather_rows"]
            frontend._workspace = lambda floats, device: torch.full((floats,), float("nan"), device=device)
            try:
                check(torch.equal(out_r, run_r(lambda: frontend.logmel_prefix(audio, lengths, cfg))),
                      "gather_rows: a NaN-filled workspace leaves the output unchanged, bitwise")
                frontend._resident_blocks = lambda *args: 7
                check(torch.equal(out_r, run_r(lambda: frontend.logmel_prefix(audio, lengths, cfg))),
                      "gather_rows: a persistent grid of 7 blocks (each over many tiles, NaN-filled slots), bitwise")
            finally:
                frontend._workspace, frontend._resident_blocks = own_workspace, own_resident
        del got, got_other, extra, by_plan, out_c
        check_counts(torch, frontend, audio, lengths, cfg, key)
        counters.zero()
        feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
        torch.cuda.synchronize()
        launches = counters.expect("extract_batch", frontend=1, **branches, **tail_branches(cfg))
        want_mask = frontend.frame_counts_reference(torch.as_tensor(batch.lengths), cfg, F)[1]
        check(torch.equal(mask.cpu(), want_mask) and bool(torch.isfinite(feat).all())
              and bool((feat[mask == 0] == 0).all()), "mask the chain's, finite, pad frames exactly 0")
        f64, _ = chain.extract_batch(batch.audio[:rows64], batch.lengths[:rows64], cfg.replace(dtype="float64"),
                                     device="cpu")
        got64 = feat[:rows64].cpu()
        if cfg.logmel_norm == "whisper":
            whisper_gate(testing, got64, f64, testing.WHISPER_ORACLE_ATOL, f"float64 chain (rows 0-{rows64 - 1})")
        elif cfg.features == "mfcc":
            err = float((got64.double() - f64).abs().max())
            print(f"  max |card - float64 chain (rows 0-{rows64 - 1})| = {err:.3e}")
            check(err <= testing.FEATURE_ATOL, f"card within {testing.FEATURE_ATOL} of the float64 chain")
        else:
            e = testing.logmel_errors(got64, f64, cfg.log_kind)
            print("  card vs the float64 chain: " + ", ".join(f"{k}={v:.3e}" for k, v in e.items()))
            check(not testing.logmel_failures(e), "card within the two-regime log-mel gate of the float64 chain")
        del feat, mask, f64, got64
        # in turns: the ladder's (dft_times), the other, the other, the ladder's
        times = dft_times(torch, chain, frontend, cfg, batch, audio, lengths, key, tag)
        prefix = lambda: frontend.logmel_prefix(audio, lengths, cfg)  # noqa: E731
        other_ms = [to_other(lambda: device_ms(torch, prefix, "logmel_kernel")) for _ in range(2)]
        ms = [times["ms"], device_ms(torch, prefix, "logmel_kernel")]
        times["ms"], other_mean = float(np.mean(ms)), float(np.mean(other_ms))
        print(f"  in turns: {key} {ms[0]:.4f}, {other} {other_ms[0]:.4f}, {other_ms[1]:.4f}, {key} {ms[1]:.4f} ms of "
              f"device time; {other} {times['bound_ms'] / other_mean * 100:.2f}% of bound, "
              f"{other_mean / times['library_ms']:.2f}x rfft; cluster / {parent} "
              f"{(times['ms'] / other_mean) ** (1 if taken else -1):.3f} {tag}")
        results[key] = dict(launches=launches[plan], max_abs_err=errs["max_abs"], **times)
        results[other_key] = dict(launches=other_launches[other], max_abs_err=other_errs["max_abs"], ms=other_mean,
                                  plain_ms=times["plain_ms"], bound_ms=times["bound_ms"],
                                  bound_by=times["bound_by"], library_ms=times["library_ms"])
        step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag, seconds=seconds)
        del audio, lengths
        torch.cuda.empty_cache()
        print(f"  {key} took {time.perf_counter() - t_case:.1f} s")
    print(f"  phase 29 took {time.perf_counter() - t_phase:.1f} s")


# phase 30's cases, the bf16x3 form in its block plans: (key, config,
# overrides, rows, seconds a row, the plan of the launch that computes the
# prefix; resampled rows take the split route, then the plain form's plan)
BF16X3_PLANS = (
    ("bf16x3_gather_4096", "classic13_deltas", dict(n_fft=4096), B, 10, "gather"),
    ("bf16x3_gather_2245", "classic13_deltas", dict(n_fft=2245), B_SMALL, 10, "gather"),
    ("bf16x3_gather_8192", "classic13_deltas", dict(n_fft=8192), B_SMALL, 10, "gather"),
    ("bf16x3_gather_hop_0.1", "classic13_deltas", dict(hop_s=0.1), B_SMALL, 10, "gather"),
    ("bf16x3_gather_frames_1.1s", "classic13_deltas", dict(win_len_s=1.1), B_SMALL, 10, "gather"),
    ("bf16x3_gather_kaldi_dither_4096", "kaldi_mfcc", dict(dither=1.0, n_fft=4096), B_SMALL, 10, "gather"),
    ("bf16x3_gather_ssc26_4096", "ssc26", dict(n_fft=4096), B_SMALL, 10, "gather"),
    ("bf16x3_gather_kaldi_plp_4096", "kaldi_plp", dict(n_fft=4096), B_SMALL, 10, "gather"),
    ("bf16x3_split_48k_hop_0.1", "mfcc39_48k", dict(hop_s=0.1), B_SMALL, 10, "gather"),
    ("bf16x3_gather_out_librosa_8192", "logmel80", LIBROSA_8192, B_SMALL, 30, "gather_out"),
    ("bf16x3_gather_24000", "classic13_deltas", dict(n_fft=24000), 4, 10, "gather"),
    ("bf16x3_gather_out_2000_filters", "classic13_deltas", dict(n_mels=2000, n_fft=4096), 4, 10, "gather_out"),
    ("bf16x3_pass_10ms_4096", "classic13_deltas", dict(win_len_s=0.01, n_fft=4096), B_SMALL, 10, "pass"),
    ("bf16x3_gather_bands_32768", "classic13_deltas", dict(n_fft=32768), 4, 10, "gather_bands"),
)
BF16X3_PLAN_COUNTERS = {"pass": "bf16_pass", "gather": "bf16_gather", "gather_bands": "bf16_gather_bands",
                        "gather_out": "bf16_gather_out"}


def bf16x3_plans_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 30: the bf16x3 form at every layout (`BF16X3_PLANS`), through
    fused_logmel_stages(dft_passes="bf16x3"): classic13_deltas at n_fft
    4,096, b64 x 10 s ("gather": the tile's A in the workspace), and at b16 x
    10 s: n_fft 2,245 (the first size the staged plan refused) and 8,192, a
    0.1 s hop and 1.1 s frames, kaldi_mfcc with dither 1.0 at n_fft 4,096
    (the dither and conditioning instantiation), ssc26 and kaldi_plp at
    4,096, mfcc39_48k at a 0.1 s hop (the split route: resample.cu, then the
    plain form's bf16x3); librosa's melspectrogram(n_fft=8192) framing at b16
    x 30 s (L = n_fft, "gather_out"); 10 ms frames at n_fft 4,096 ("pass":
    A in shared memory); n_fft 24,000, 32,768 ("gather_bands") and 2,000
    filters ("gather_out") at b4 x 10 s. For each: the plan, tile, ring
    stages and shared bytes; threads, registers and spills (none); the
    launch counted by plan; the kernel against its
    plain version at the bf16x3 gates and, on its first rows, against the
    float64 plain version on the CPU at the loud-bin gate; int16 rows ==
    float32 rows and two runs, bitwise; the counts and mask; device time,
    the plain version, rfft(n=n_fft), the function's bound, the three
    products at the bf16 peak and the matrix each tile reads at the HBM
    rate."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    print("== 30. bf16x3 at every layout: the block plans (the tile's A in shared memory, then A, bands "
          "and accumulators in device memory)")
    for key, name, over, rows, seconds, plan in BF16X3_PLANS:
        t_case = time.perf_counter()
        cfg = named_config(name).replace(**over)
        at = frontend.feature_rate_config(cfg)
        sr = cfg.input_sample_rate or cfg.sample_rate
        n = sr * seconds
        batch = make_batch(pad_batch, cfg, rows, n, 571 * sr // cfg.sample_rate, seed=sum(map(ord, key)))
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        got_plan, tile, stages = frontend.bf16_layout(at)
        kp, nbp = frontend.bf16_dims(at)
        matrix = frontend.bf16_matrix_bytes(at)[0]
        route = frontend.resample_route(cfg, "bf16x3")
        print(f"   {key}: {name} {over} b{rows} x {seconds} s int16 {list(batch.audio.shape)}"
              f"{f', {route} route' if route else ''}: plan {got_plan}, {tile} frames a block, "
              f"{stages} ring stages, {frontend.smem_bytes(at, 'bf16x3'):,} B a block; matrix [{kp}, "
              f"{2 * nbp}] bf16 x 2, {matrix:,} B")
        check(got_plan == plan and frontend.layout_reason(cfg, "bf16x3") is None, f"{key} takes {plan}")
        info = frontend.kernel_info(cfg, True, "bf16x3")
        print(f"    {info}")
        check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, "no spills, launchable")
        kind = frontend.feature_kind(at)
        branches = {"bf16x3": 1, BF16X3_PLAN_COUNTERS[plan]: 1,
                    **({kind: 1} if kind in ("plp", "spectrogram", "ssc") else {}),
                    **{k: v for k, v in plan_branches(chain, frontend, at).items()
                       if k in ("conditioning", "dither", "centered")}}
        if route == "split":
            branches.update(split=1, resample=1)
        counters.zero()
        st = frontend.fused_logmel_stages(audio, lengths, cfg, dft_passes="bf16x3")
        torch.cuda.synchronize()
        launches = counters.expect("fused_logmel_stages(dft_passes='bf16x3')", frontend=1, **branches)
        got = st["prefix"]
        F = got.shape[1]
        check(tuple(got.shape) == (rows, F, cfg.n_mels + 1) and bool(torch.isfinite(got).all()),
              f"prefix shape {tuple(got.shape)}, finite")
        plain = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
        errs = testing.prefix_errors(got, plain, cfg.n_mels, cfg.log_kind, cfg.features)
        del plain
        print("    kernel vs its plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        fails = testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL)
        check(not fails, f"within the bf16x3 gates of the plain version {fails or ''}")
        k64 = 2
        f64 = frontend.logmel_prefix_reference(audio[:k64].cpu(), lengths[:k64].cpu(), cfg.replace(dtype="float64"))
        e64 = testing.prefix_errors(got[:k64].cpu(), f64, cfg.n_mels, cfg.log_kind, cfg.features)
        del f64
        print(f"    rows 0-{k64 - 1} vs the float64 plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in e64.items()))
        if "logmel_loud_max_abs" in e64:
            check(e64["logmel_loud_max_abs"] < testing.BF16X3_LOUD_ATOL, "loud bins within 1e-3 of float64")
        check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes="bf16x3"))
              and torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")),
              "int16 rows == float32 rows, and two runs equal, bitwise")
        del got, st
        check_counts(torch, frontend, audio, lengths, cfg, key, "bf16x3")
        kernel_ms = device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3"),
                              "logmel_kernel")
        plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3"),
                           reps=3, warmup=1)
        rows16, lens16 = audio, lengths
        if route == "split":
            rows16, lens16 = frontend.rs_kernel.resample_rows(audio, lengths, cfg.input_sample_rate,
                                                              cfg.sample_rate)
        stg = chain.logmel_stages(rows16, lens16, at)
        framed = stg["windowed"].reshape(rows * F, -1).contiguous()
        del stg
        rfft_ms = device_ms(torch, lambda: torch.fft.rfft(framed, n=at.n_fft, dim=-1))
        del framed
        lens = np.minimum(lens16.cpu().numpy().astype(np.int64), rows16.shape[1])
        frames = int(sum(min(F, math.ceil(x / at.frame_step)) for x in lens)) if not chain.centered(at) \
            else F * int(np.count_nonzero(lens > 0))
        bound_ms, bound_by = bound(frontend_bytes(at, frontend, lens, rows, F) + matrix,
                                   frontend_ops(at, chain, frontend, torch, lens, F))
        tensor_ms = 3 * 2 * kp * 2 * at.n_bins * frames / PEAK_BF16_FLOPS * 1e3
        tiles = rows * -(-F // tile)
        matrix_ms = tiles * matrix / PEAK_BYTES_PER_S * 1e3
        print(f"    bf16x3 kernel ({plan}): {kernel_ms:.4f} ms of device time, L2 flushed "
              f"({bound_ms / kernel_ms * 100:.2f}% of the function's bound; {kernel_ms / rfft_ms:.2f}x rfft) {tag}")
        print(f"    the three bf16 products alone: {tensor_ms:.4f} ms at {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s; "
              f"the matrix read whole by each of {tiles} tiles: {tiles * matrix / 1e9:.2f} GB, {matrix_ms:.4f} ms "
              f"at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s (from L2 where it fits its 50 MB)")
        print(f"    plain version (three fp32 matmuls of bf16 parts): {plain_ms:.4f} ms; torch.fft.rfft(n={at.n_fft}) "
              f"on [{rows * F}, {at.frame_length}] (DFT only): {rfft_ms:.4f} ms of device time {tag}")
        results[key] = dict(launches=launches[BF16X3_PLAN_COUNTERS[plan]], max_abs_err=errs["max_abs"],
                            ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=rfft_ms)
        del audio, lengths, rows16, lens16
        torch.cuda.empty_cache()
        print(f"  {key} took {time.perf_counter() - t_case:.1f} s")
    print(f"  phase 30 took {time.perf_counter() - t_phase:.1f} s")


# phase 31's cases, tens of thousands of filters: (key, config, overrides,
# rows, seconds a row, the plan, the dft_passes route, the rows' seed: the
# rows each config has been held on since the port first took it); the
# host-bound case first, while the run is young
MANY_FILTERS = (
    ("cluster_131072_16385_filters", "classic13_deltas", dict(n_fft=131072, n_mels=16385), 2, 30,
     "cluster", "radix4", 2381),
    ("wide_40000_filters", "classic13_deltas", dict(n_mels=40000), B_SMALL, 10, "wide", "radix4", 2445),
    ("wide_60000_filters", "classic13_deltas", dict(n_mels=60000), B_SMALL, 10, "wide", "radix4", 2383),
    ("wide_ssc26_30000_filters", "ssc26", dict(n_mels=30000, n_fft=4096), B_SMALL, 10, "wide", "radix4", 2908),
    ("wide_logmel80_33000_filters", "logmel80", dict(n_mels=33000), 4, 10, "wide", "radix4", 3286),
    ("bf16x3_gather_out_40000_filters", "classic13_deltas", dict(n_mels=40000), B_SMALL, 10, "gather_out", "bf16x3",
     2838),
)
# a recorded fault (ROADMAP.md queue 3 item 5), held apart on rows of its
# own: the fp32 chain's cepstra at 40,000 filters read ~2e-3 from the
# float64 chain on these rows, the CPU's as the card's (a quiet bin's fp32
# power, shared by ~155 filters of one weight, summed by the DCT and scaled
# ~12x by the lifter), over the 5e-4 + 1e-5|f| gate: (case key, the rows'
# seed). The card is held no further from float64 than the CPU fp32 chain
# plus the gate, and to the gate itself once the CPU chain is within it.
FP32_CHAIN_FAULTS = {"wide_40000_filters": 1620}


# phase 31 leaves its n_fft 131,072 case out of a run already this many
# seconds old (its dense tables take minutes of host time; the limit is 1,200)
HOST_BOUND_AFTER_S = 650
# phase 31's tail entry of the kernels line: the split's base kernel (past
# 1,024 lanes), at the case that times it
TAIL_KEYS = {"wide_60000_filters": "tail_base_60000_filters"}


def mem_available() -> int:
    """Bytes of host memory available (/proc/meminfo MemAvailable)."""
    for line in pathlib.Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def nan_gate(torch, testing, got, want, cfg, what: str, narrow=None, rows=None) -> dict[str, float]:
    """A prefix against a reference at the prefix gates: NaN, an SSC filter
    with no weight (0/0 in every version), in the same places on every row;
    the other lanes at the gates (`narrow` lanes at the per-bin gate) on
    `rows` (every row by default), a row at a time on the host (each gate is
    a max, so the rows' max is theirs)."""
    want = want.to(got.device)
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan), f"{what}: NaN where the reference has it")
    nans = int(nan.sum())
    del nan
    errs: dict[str, float] = {}
    for i in range(got.shape[0]) if rows is None else rows:
        g, w = got[i].cpu(), want[i].cpu()
        m = torch.isnan(w)
        e = testing.prefix_errors(g.masked_fill(m, 0.0), w.masked_fill(m, 0.0), cfg.n_mels, cfg.log_kind,
                                  cfg.features, narrow)
        errs = {k: max(v, errs.get(k, 0.0)) for k, v in e.items()}
    print(f"    {what}{'' if rows is None else f' (rows {list(rows)})'}: "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + (f"; {nans} NaN lanes (filters with no weight) in both" if nans else ""))
    return errs


def features_gate(torch, testing, got, want, cfg, what: str) -> None:
    """Lane-wise features (log-mel, PLP, SSC) against the float64 chain at
    the family's gate (log-mel the two-regime gate; PLP and SSC
    FAMILY_GATES' float64 ones), NaN in the same places."""
    g, w = got.double().cpu(), want.double().cpu()
    nan = torch.isnan(w)
    check(torch.equal(torch.isnan(g), nan), f"{what}: NaN where the float64 chain has it")
    g, w = g.masked_fill(nan, 0.0), w.masked_fill(nan, 0.0)
    if cfg.features == "logmel":
        errs = testing.logmel_errors(g, w, cfg.log_kind)
        fails = testing.logmel_failures(errs)
    else:
        errs = testing.family_feature_errors(g, w, cfg.features, "float64")
        fails = testing.family_feature_failures(errs, cfg.features, "float64")
    print(f"    {what}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    check(not fails, f"{what} within the family's gate {fails or ''}")


def fault_rows(torch, chain, testing, pad_batch, cfg, n: int, seed: int) -> None:
    """A recorded fault of the fp32 chain (`FP32_CHAIN_FAULTS`): two rows of
    n samples from `seed` through the card's chain, the CPU fp32 chain and
    the float64 chain; each one's excess over 1e-5 |f| from float64
    printed; the card held to the gate's FEATURE_ATOL where the CPU fp32
    chain is within it, else no further than the CPU chain's excess plus
    FEATURE_ATOL (the kernels add at most the gate to the fp32 chain's own
    error)."""
    batch = make_batch(pad_batch, cfg, 2, n, 571, seed=seed)
    card, _ = chain.extract_batch(batch.audio, batch.lengths, cfg)
    f64, _ = chain.extract_batch(batch.audio, batch.lengths, cfg.replace(dtype="float64"), device="cpu")
    cpu, _ = chain.extract_batch(batch.audio, batch.lengths, cfg, device="cpu")
    over = lambda got: float(((got.double().cpu() - f64).abs() - testing.FEATURE_RTOL * f64.abs()).max())  # noqa: E731
    e_card, e_cpu = over(card), over(cpu)
    limit = testing.FEATURE_ATOL if e_cpu <= testing.FEATURE_ATOL else e_cpu + testing.FEATURE_ATOL
    print(f"    the fp32 chain's recorded fault (ROADMAP.md queue 3 item 5), rows of seed {seed}: cepstra over "
          f"1e-5 |f| from the float64 chain: card {e_card:.3e}, the CPU fp32 chain {e_cpu:.3e}; gate "
          f"{testing.FEATURE_ATOL}: " + ("the CPU fp32 chain is within it now (the fault is gone)"
                                         if e_cpu <= testing.FEATURE_ATOL else "still over it"))
    check(e_card <= limit, f"card cepstra on the fault's rows within {limit:.3e} of the float64 chain "
                           "(the CPU fp32 chain's excess plus the gate)")


def many_filters_path(torch, counters, tag: str, results: dict, t_script: float, breakdown=None,
                      cuts: dict | None = None) -> None:
    """Phase 31: every filter count (`MANY_FILTERS`): the packed mel table
    holds each weight's bin alone, so 32,768 filters and more (16,384 at
    n_fft 131,072) are taken; the wide plan takes tens of thousands of
    filters (a tile's power rows in shared memory, the projection filter by
    filter), where "gather_bands" and "gather_sums" (the projection's sums in
    device memory) took them: each of those forced beside it, held to its
    plain version, timed, and its output against the wide plan's (bitwise
    where every filter has one weight and the FFT stage runs the same
    groups; else the largest difference, lanes and energy apart, printed).
    For each: the plan, no spills, the launch
    counted by plan; the kernel against its plain version on the card in
    float64 (the fp32 one printed, but at n_fft 131,072) at the prefix
    gates on the first and last rows, NaN in the same places on every row,
    filters of at most
    two weights at the per-bin gate; int16 ==
    float32, two runs, and in the plans with a workspace (the forced parents
    "gather_sums" and "gather_rows", the bf16x3 "gather_out") a NaN-filled
    one and a persistent grid of 7 blocks, bitwise, the forced parents
    int16 == float32 and two runs too; the counts and mask;
    extract_batch counted (fused_logmel_stages(dft_passes="bf16x3") for the
    bf16x3 case), for mfcc the tail against its plain version on the
    kernel's prefix and the cepstra on rows 0-1 within 5e-4 + 1e-5·|f| of
    the float64 chain (the CPU fp32 chain's distance printed beside), the
    other families' features on rows 0-1 within their gate of the float64
    chain (none at n_fft 131,072, whose float64 CPU chain would take
    minutes); device time, the plain version, rfft(n=n_fft) and the bound;
    for the wide plan, with the breakdown's cuts (`cuts`, phase 2's builds),
    its staging, FFT stage and projection in turns.
    The n_fft 131,072 case builds its dense float64 mel matrix and its
    copies on the host (~45 GB at 16,385 filters, 1.5-2 minutes of host
    time): a host without that memory, or a run already HOST_BOUND_AFTER_S
    seconds old (the script's limit is 1,200), leaves it out, and says so."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend, tail
    from mfcc_tpu_torch.ops import chain, constants
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    print("== 31. every filter count: the packed table without a filter field, the wide plan (the projection "
          "filter by filter over a tile of frames), the tail's base as a sum of stretches")
    own_workspace, own_resident = frontend._workspace, frontend._resident_blocks
    bits = lambda t: t.contiguous().view(torch.int32)  # noqa: E731  (NaN-safe bitwise)

    def workspace_checks(ref, run, plan: str) -> None:
        """The plans with a workspace ("gather_rows", "gather_sums", the
        bf16x3 "gather_out"): a NaN-filled workspace, then (but
        "gather_out") a persistent grid of 7 blocks, leave run()'s output
        ref unchanged, bitwise."""
        frontend._workspace = lambda floats, device: torch.full((floats,), float("nan"), device=device)
        try:
            check(torch.equal(bits(ref), bits(run())), f"{plan}: a NaN-filled workspace leaves the output "
                                                       "unchanged, bitwise")
            if plan != "gather_out":
                frontend._resident_blocks = lambda *args: 7
                check(torch.equal(bits(ref), bits(run())),
                      f"{plan}: a persistent grid of 7 blocks (each over many tiles, NaN-filled slots), bitwise")
        finally:
            frontend._workspace, frontend._resident_blocks = own_workspace, own_resident
    for key, name, over, rows, seconds, plan, passes, seed in MANY_FILTERS:
        t_case = time.perf_counter()
        cfg = named_config(name).replace(**over)
        host = 5 * 8 * cfg.n_bins * cfg.n_mels  # the dense float64 mel, its copies and band temporaries
        if host > 32e9 and host > 0.8 * mem_available():
            print(f"   {key}: left out: ~{host / 1e9:.0f} GB of host memory for the dense mel matrix, "
                  f"{mem_available() / 1e9:.0f} GB available")
            continue
        if host > 32e9 and time.perf_counter() - t_script > HOST_BOUND_AFTER_S:
            print(f"   {key}: left out: the script is {time.perf_counter() - t_script:.0f} s old, over "
                  f"{HOST_BOUND_AFTER_S} s, and its dense tables take minutes of host time")
            continue
        bf16 = passes == "bf16x3"
        n = cfg.sample_rate * seconds
        batch = make_batch(pad_batch, cfg, rows, n, 571, seed=seed)
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        F = cfg.num_frames(batch.audio.shape[1])
        layout = frontend.bf16_layout(cfg) if bf16 else frontend.fft_layout(cfg)
        print(f"   {key}: {name} {over} b{rows} x {seconds} s int16 {list(batch.audio.shape)}, {F} frames, "
              f"{passes}: {layout}, {frontend.smem_bytes(cfg, passes):,} B a block, "
              f"{frontend.packed_count(cfg):,} packed weights")
        check(layout[0] == plan and chain.unsupported_reason(cfg) is None and frontend.layout_reason(cfg) is None
              and frontend.layout_reason(cfg, "bf16x3") is None, f"{key} takes {plan}, nothing refused")
        info = frontend.kernel_info(cfg, True, passes)
        print(f"    {info}")
        check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, "no spills, launchable")
        kind = frontend.feature_kind(cfg)
        kinds = {kind: 1} if kind in ("plp", "spectrogram", "ssc") else {}
        if bf16:
            branches, counter = {"bf16x3": 1, "bf16_gather_out": 1, **kinds}, "bf16_gather_out"
        else:
            branches, counter = {**plan_branches(chain, frontend, cfg), **kinds}, plan
        counters.zero()
        got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes=passes)
        torch.cuda.synchronize()
        launches = counters.expect("the kernel", frontend=1, **branches)
        check(tuple(got.shape) == (rows, F, cfg.n_mels + 1), f"prefix shape {tuple(got.shape)}")
        narrow = None
        if not bf16 and cfg.features != "ssc":
            narrow = testing.narrow_lanes(chain.device_constants(cfg, torch.device("cpu"), torch.float32)["mel"])
            print(f"    {int(narrow.sum())} of {cfg.n_mels} filters narrow (at most {testing.NARROW_WEIGHTS} "
                  f"weights): the per-bin gate")
        chunk = max(1, 2**30 // (F * (cfg.n_mels + cfg.n_bins) * 8))
        # the gates' rows: the first and the last, the shortest (the host's
        # numpy takes seconds a row at tens of thousands of lanes); the NaN
        # check, the bitwise ones and the counts take every row
        spread = [0, rows - 1]
        e32 = {}
        if bf16 or cfg.n_fft <= 16384:  # the bf16x3 route's gate; else printed on rows 0-1
            k32 = rows if bf16 else 2
            plain32 = torch.cat([frontend.logmel_prefix_reference(audio[i:i + chunk], lengths[i:i + chunk], cfg,
                                                                  dft_passes=passes) for i in range(0, k32, chunk)])
            e32 = nan_gate(torch, testing, got[:k32], plain32[:k32], cfg,
                           "kernel vs its fp32 plain version" + ("" if bf16 else " (rows 0-1)"), narrow,
                           spread if bf16 else None)
            del plain32
        if bf16:
            errs = e32
            fails = testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL)
        else:
            want = cfg.replace(dtype="float64")
            plain64 = torch.cat([frontend.logmel_prefix_reference(audio[i:i + chunk], lengths[i:i + chunk], want)
                                 for i in range(0, rows, chunk)])
            errs = nan_gate(torch, testing, got, plain64, cfg, "kernel vs its float64 plain version on the card",
                            narrow, spread)
            if plan in ("cluster", "wide"):  # the parent's plan, forced, against the same version
                to_parent = forced_layout(frontend, without_cluster(frontend) if plan == "cluster"
                                          else without_wide(frontend))
                parent = to_parent(lambda: frontend.fft_plan(cfg))
                parent_branches = {**to_parent(lambda: plan_branches(chain, frontend, cfg)), **kinds}
                counters.zero()
                got_parent = to_parent(lambda: frontend.logmel_prefix(audio, lengths, cfg))
                torch.cuda.synchronize()
                parent_launches = counters.expect(f"the parent's plan ({parent}), forced", frontend=1,
                                                  **parent_branches)
                perr = nan_gate(torch, testing, got_parent, plain64, cfg,
                                f"the parent's plan ({parent}) vs the float64 plain version", narrow, spread)
                check(not testing.prefix_failures(perr), f"{parent}: within the prefix gates of its plain version")
                run_parent = lambda: to_parent(lambda: frontend.logmel_prefix(audio, lengths, cfg))  # noqa: E731
                check(torch.equal(bits(got_parent), bits(to_parent(
                          lambda: frontend.logmel_prefix(audio.float(), lengths, cfg))))
                      and torch.equal(bits(got_parent), bits(run_parent())),
                      f"{parent}: int16 rows == float32 rows, and two runs equal, bitwise")
                if parent in ("gather_rows", "gather_sums"):
                    workspace_checks(got_parent, run_parent, parent)
                parent_ms = to_parent(lambda: device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg),
                                                        "logmel_kernel"))
                if plan == "wide":
                    M = cfg.n_mels
                    same = torch.equal(bits(got), bits(got_parent))
                    d = (got - got_parent).abs().nan_to_num(0.0)
                    print(f"    the wide plan vs {parent} (groups {frontend.wide_layout(cfg)[0]} vs "
                          f"{to_parent(lambda: frontend.fft_layout(cfg))[1]}): bitwise equal {same}; largest "
                          f"difference: lanes [0, {M}) {float(d[..., :M].max()):.3e}, the energy lane "
                          f"{float(d[..., M].max()):.3e}; {frontend.packed_count(cfg):,} weights for {M:,} filters")
                    if frontend.packed_count(cfg) == M and frontend.wide_layout(cfg)[0] == \
                            to_parent(lambda: frontend.fft_layout(cfg))[1]:
                        check(same, f"{key}: bitwise {parent}'s output (one weight a filter, the same groups)")
                    del d
                del got_parent
            del plain64
            fails = testing.prefix_failures(errs)
        check(not fails, f"{key}: within the prefix gates of its plain version {fails or ''}")
        check(torch.equal(bits(got), bits(frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes=passes)))
              and torch.equal(bits(got), bits(frontend.logmel_prefix(audio, lengths, cfg, dft_passes=passes))),
              "int16 rows == float32 rows, and two runs equal, bitwise")
        if plan == "gather_out":
            workspace_checks(got, lambda: frontend.logmel_prefix(audio, lengths, cfg, dft_passes=passes), plan)
        del got
        check_counts(torch, frontend, audio, lengths, cfg, key, passes)
        counters.zero()
        if bf16:
            st = frontend.fused_logmel_stages(audio, lengths, cfg, dft_passes="bf16x3", feature_tail=True)
            torch.cuda.synchronize()
            counters.expect("fused_logmel_stages(dft_passes='bf16x3', feature_tail=True)", frontend=1, **branches,
                            **tail_branches(cfg))
            feat, mask = st["features_fused"], st["frame_mask"]
        else:
            feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
            torch.cuda.synchronize()
            launches_x = counters.expect("extract_batch", frontend=1, **branches, **tail_branches(cfg))
        want_mask = frontend.frame_counts_reference(torch.as_tensor(batch.lengths), cfg, F)[1]
        pad = feat[mask == 0]
        check(torch.equal(mask.cpu(), want_mask) and bool(((pad == 0) | torch.isnan(pad)).all())
              and bool((torch.isfinite(feat) | torch.isnan(feat)).all()),
              "mask the chain's, pad frames exactly 0 (NaN in the lanes of SSC filters with no weight)")
        if bf16:  # its own accuracy class: the prefix's loud bins against float64 (phase 30's gate)
            f64 = frontend.logmel_prefix_reference(audio[:2].cpu(), lengths[:2].cpu(), cfg.replace(dtype="float64"))
            e64 = nan_gate(torch, testing, frontend.logmel_prefix(audio[:2], lengths[:2], cfg, dft_passes="bf16x3"),
                           f64, cfg, "bf16x3 prefix (rows 0-1) vs the float64 plain version")
            check(e64["logmel_loud_max_abs"] < testing.BF16X3_LOUD_ATOL, "loud bins within 1e-3 of float64")
            del f64
        elif cfg.features == "mfcc":
            # the tail against its plain version on the front-end's own
            # prefix (its DCT sums tens of thousands of lanes), then the
            # cepstra against the float64 chain
            prefix, nv, _ = frontend.logmel_prefix_counts(audio, lengths, cfg)
            errs_t = testing.tail_errors(feat, tail.feature_tail_reference(prefix, nv, cfg))
            print("    the tail vs its plain version on the kernel's prefix: "
                  + ", ".join(f"{k}={v:.3e}" for k, v in errs_t.items()))
            check(not testing.tail_failures(errs_t), "the tail within max(2e-4, 2e-5 max|f|) of its plain version")
            # the split's passes, its base kernel's stretches past 1,024 lanes
            tail_ms = device_ms(torch, lambda: tail.feature_tail(prefix, nv, cfg), None)
            tail_plain_ms = cuda_ms(torch, lambda: tail.feature_tail_reference(prefix, nv, cfg), reps=3, warmup=1)
            tail_bound_ms, tail_by = tail_bound(cfg, rows, F, int(nv.sum()))
            print(f"    feature tail, {tail.plan(cfg)[0]} plan, base by {tail.split_base(cfg)}: {tail_ms:.4f} ms "
                  f"of device time, L2 flushed ({tail_bound_ms / tail_ms * 100:.2f}% of its bound); plain version "
                  f"{tail_plain_ms:.4f} ms {tag}")
            if key in TAIL_KEYS:  # the base kernel alone: its device time and its own bound
                base_ms = device_ms(torch, lambda: tail.feature_tail(prefix, nv, cfg), "tail_base_kernel")
                base_bound_ms, base_by = tail_bound(cfg, rows, F, int(nv.sum()), base_only=True)
                print(f"    its base kernel: {base_ms:.4f} ms of device time, L2 flushed "
                      f"({base_bound_ms / base_ms * 100:.2f}% of its bound) {tag}")
                results[TAIL_KEYS[key]] = dict(
                    launches=launches_x["tail_base"], max_abs_err=errs_t["max_abs"], ms=base_ms,
                    plain_ms=tail_plain_ms, bound_ms=base_bound_ms, bound_by=base_by, library_ms=None)
            del prefix
            if cfg.n_fft <= 16384:
                f64, _ = chain.extract_batch(batch.audio[:2], batch.lengths[:2], cfg.replace(dtype="float64"),
                                             device="cpu")
                cpu, _ = chain.extract_batch(batch.audio[:2], batch.lengths[:2], cfg, device="cpu")
                d = (feat[:2].double().cpu() - f64).abs()
                excess = float((d - testing.FEATURE_RTOL * f64.abs()).max())
                print(f"    features (rows 0-1) vs the float64 chain: max |diff| card {float(d.max()):.3e} "
                      f"(over 1e-5 |f|: {excess:.3e}), the CPU fp32 chain {float((cpu.double() - f64).abs().max()):.3e}")
                check(excess <= testing.FEATURE_ATOL, f"card cepstra within {testing.FEATURE_ATOL} + 1e-5 |f| of the "
                                                      "float64 chain (rows 0-1)")
                del f64, cpu, d
                if key in FP32_CHAIN_FAULTS:
                    fault_rows(torch, chain, testing, pad_batch, cfg, n, FP32_CHAIN_FAULTS[key])
        elif cfg.n_fft <= 16384:
            f64, _ = chain.extract_batch(batch.audio[:2], batch.lengths[:2], cfg.replace(dtype="float64"),
                                         device="cpu")
            features_gate(torch, testing, feat[:2], f64, cfg, "card features (rows 0-1) vs the float64 chain")
            del f64
        else:
            print("    features vs the float64 chain: not computed (its CPU rfft and mel product at "
                  f"n_fft {cfg.n_fft} and {cfg.n_mels} filters take minutes)")
        del feat, mask
        kernel_ms = device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg, dft_passes=passes),
                              "logmel_kernel")
        plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes=passes),
                           reps=3, warmup=1)
        stg = chain.logmel_stages(audio, lengths, cfg)
        framed = stg["windowed"].reshape(rows * F, -1).contiguous()
        del stg
        rfft_ms = device_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
        del framed
        lens = np.minimum(batch.lengths.astype(np.int64), batch.audio.shape[1])
        matrix = frontend.bf16_matrix_bytes(cfg)[0] if bf16 else 0
        bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, rows, F) + matrix,
                                   frontend_ops(cfg, chain, frontend, torch, lens, F))
        print(f"    front-end kernel ({passes}, {plan}): {kernel_ms:.4f} ms of device time, L2 flushed "
              f"({bound_ms / kernel_ms * 100:.2f}% of its bound, by {bound_by}; {kernel_ms / rfft_ms:.2f}x rfft); "
              f"launches {launches[counter]} {tag}")
        print(f"    plain version: {plain_ms:.4f} ms (events); torch.fft.rfft(n={cfg.n_fft}) on "
              f"[{rows * F}, {cfg.frame_length}] (DFT only): {rfft_ms:.4f} ms of device time {tag}")
        if plan == "wide" and cuts:
            ms = breakdown.time_cuts(torch, frontend, cuts, cfg, audio, lengths,
                                     timer=lambda fn: device_ms(torch, fn, "logmel_kernel"))
            p0, p1, p2 = (float(np.mean(ms[c])) for c in (0, 1, 2))
            print(f"    breakdown (profiler device time, L2 flushed, cuts in turns): staging {p1:.4f} ms, "
                  f"FFT stage {p2 - p1:.4f}, projection {p0 - p2:.4f}, whole {p0:.4f} {tag}")
        results[key] = dict(launches=launches[counter], max_abs_err=errs["max_abs"], ms=kernel_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms)
        if plan in ("cluster", "wide"):
            print(f"    the parent's plan ({parent}), forced: {parent_ms:.4f} ms of device time, L2 flushed "
                  f"({bound_ms / parent_ms * 100:.2f}% of its bound); the {plan} plan {kernel_ms / parent_ms:.3f}x "
                  f"it {tag}")
            results[key.replace(f"{plan}_", f"{parent}_", 1)] = dict(
                launches=parent_launches[parent], max_abs_err=perr["max_abs"], ms=parent_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms)
        del audio, lengths
        if cfg.n_fft > 16384:  # the dense tables of the largest case
            chain.device_constants.cache_clear()
            constants.chain_constants.cache_clear()
            frontend._device_tables.cache_clear()
        torch.cuda.empty_cache()
        print(f"  {key} took {time.perf_counter() - t_case:.1f} s")
    print(f"  phase 31 took {time.perf_counter() - t_phase:.1f} s")


def new_form_paths(torch, counters, tag: str, results: dict) -> None:
    """Phases 13-18: whisper80 ragged, centered framing with conditioning
    and dither, the Bluestein form (n_fft 404 and 551, timed) and its block
    FFT plan (1102, timed), a radix-3 Stockham size (n_fft 480), frames longer
    than n_fft, and rows over the reference's 8 MiB slab bound (timed)."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain

    n16 = 16000 * SECONDS
    n30 = 16000 * WHISPER_SECONDS
    ragged = [n30 - 1713 * i for i in range(B_SMALL - len(WHISPER_SHORT))] + WHISPER_SHORT
    print(f"== 13. path whisper80, ragged b{B_SMALL} x 30 s (lengths 480,000 - 1,713 i and "
          f"{WHISPER_SHORT})")
    small_path(torch, counters, named_config("whisper80"), ragged, n30, 18, "whisper80 ragged",
               testing.WHISPER_ATOL, testing.WHISPER_ORACLE_ATOL, prefix64=True)

    print("== 14. centered framing with conditioning and dither")
    lens = [n16 - 571 * i for i in range(B_SMALL - 2)] + [250, 90]
    cfg = named_config("kaldi_mfcc").replace(frame_tail="center", dither=1.0)
    small_path(torch, counters, cfg, lens, n16, 19, "kaldi_mfcc center, dither 1.0",
               testing.KALDI_MFCC_ATOL)
    cfg = named_config("classic13_deltas").replace(frame_tail="center", dither=1.0)
    small_path(torch, counters, cfg, lens, n16, 20,
               "classic13_deltas center, dither 1.0 (signal pre-emphasis at the source index)",
               testing.FEATURE_ATOL)

    bluestein_path(torch, counters, tag, results)
    lens = [n16 - 571 * i for i in range(B_SMALL)]

    print(f"== 16. a radix-3 Stockham size: classic13 n_fft 480 (240 = 8*2*3*5) b{B_SMALL}")
    cfg = named_config("classic13").replace(n_fft=480)
    _, audio, lengths, _, _ = small_path(torch, counters, cfg, lens, n16, 22,
                                         "classic13 n_fft 480", testing.FEATURE_ATOL, prefix64=True)
    print(f"  frontend kernel at n_fft 480: "
          f"{cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg)):.4f} ms {tag}")
    del audio, lengths

    print(f"== 17. frames longer than n_fft: kaldi_mfcc 40 ms frames at n_fft 512 b{B_SMALL}")
    cfg = named_config("kaldi_mfcc").replace(win_len_s=0.040, n_fft=512)
    small_path(torch, counters, cfg, lens, n16, 23, "kaldi_mfcc L 640", testing.KALDI_MFCC_ATOL)
    cfg = cfg.replace(energy_source="windowed_frame", dither=1.0)
    small_path(torch, counters, cfg, lens, n16, 24, "kaldi_mfcc L 640, windowed energy, dither",
               testing.KALDI_MFCC_ATOL)

    n = 16000 * LONG_SECONDS
    print(f"== 18. rows over the reference's 8 MiB slab bound: classic13_deltas b2 x "
          f"{LONG_SECONDS} s ({n:,} samples a row)")
    cfg = named_config("classic13_deltas")
    batch, audio, lengths, errs, launches = small_path(
        torch, counters, cfg, [n, n - 16001], n, 25, "classic13_deltas 140 s",
        testing.FEATURE_ATOL)
    F = cfg.num_frames(batch.audio.shape[1])
    event_ms, plain_ms, rfft_ms = kernel_times(torch, chain, frontend, cfg, audio, lengths, F)
    kernel_ms = device_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg), "logmel_kernel")
    lens64 = batch.lengths.astype(np.int64)
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens64, 2, F),
                               frontend_ops(cfg, chain, frontend, torch, lens64, F))
    print(f"  frontend kernel, b2 x {LONG_SECONDS} s: {kernel_ms:.4f} ms of device time, L2 flushed "
          f"({bound_ms / kernel_ms * 100:.1f}% of bound); CUDA events {event_ms:.4f} ms {tag}")
    print(f"  plain version: {plain_ms:.4f} ms; torch.fft.rfft on [{2 * F}, 512] (DFT only): "
          f"{rfft_ms:.4f} ms {tag}")
    results["long_rows"] = dict(launches=launches["frontend"], max_abs_err=errs["max_abs"],
                                ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=rfft_ms)


def tail_bound(cfg, B: int, F: int, frames: int, base_only: bool = False) -> tuple[float, str]:
    """The feature tail's bound: it reads the prefix rows of the `frames`
    valid frames (rows past an utterance's n_valid are never read), the
    valid frame counts and dct_aug, and writes all of [B, F, feat_dim] (pad
    rows are zeroed), each once; per valid frame it does the energy lane's
    log, clamp and floor (3), the [n_mels+1] x [n_ceps] product (2 M1 C) and
    per delta order C (3N + 1) (N differences, products and sums, one
    division); CMVN adds per valid value a sum, a centring, a square, a sum
    and the division (5 D). base_only: the split's base pass alone, which
    writes base on the valid rows and the pad rows' zeros (no deltas, no
    CMVN)."""
    M1, C, N, D = cfg.n_mels + 1, cfg.n_ceps, cfg.delta_window, cfg.feat_dim
    if base_only:
        nbytes = 4 * (frames * M1 + B + M1 * C + frames * C + (B * F - frames) * D)
        per_frame = 3 + 2 * M1 * C
        print(f"  the split's base alone: {frames} valid frames x {per_frame} operations")
        return bound(nbytes, frames * per_frame)
    nbytes = 4 * (frames * M1 + B + M1 * C + B * F * D)
    per_frame = 3 + 2 * M1 * C + cfg.deltas * C * (3 * N + 1)
    if cfg.cmvn == "utterance":
        per_frame += 5 * D
    print(f"  feature tail: {frames} valid frames x {per_frame} operations")
    return bound(nbytes, frames * per_frame)


def main_path_tail(torch, chain, testing, tail, cfg, prefix, lengths, feat, mask, launches,
                   tag: str) -> dict:
    """Phase 3's feature tail: the kernel on the front-end kernel's own
    b64 x 10 s prefix against its plain version (the torch epilogue), masks
    equal, pad rows exactly 0, extract_batch's features bitwise those of the
    kernel on that prefix; the kernel and the epilogue timed in turns, and the
    device times of both from the profiler. The kernel's `ms` is its device
    time with L2 flushed before each launch: CUDA events around a launch of
    ~0.03 ms also hold the host's time in the Python wrapper, whose launch
    the card waits for."""
    nv = chain.num_valid_frames(lengths, cfg).to(torch.int32)
    got = tail.feature_tail(prefix, nv, cfg)
    torch.cuda.synchronize()
    want = tail.feature_tail_reference(prefix, nv, cfg)
    errs = testing.tail_errors(got, want)
    print("  feature tail vs its plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    check(not testing.tail_failures(errs), "feature tail within max(2e-4, 2e-5 max|f|) of the plain version")
    check(torch.equal(chain.frame_mask(nv, prefix.shape[1], torch.float32), mask),
          "the tail's mask is extract_batch's")
    check(bool((got[mask == 0] == 0).all()), "the tail's pad rows exactly 0")
    check(torch.equal(got, feat), "extract_batch's features == the tail kernel's on the same prefix, bitwise")
    print(f"  times {tag}")
    runs = []
    for _ in range(2):  # in turns: kernel, epilogue, kernel, epilogue
        runs.append((cuda_ms(torch, lambda: tail.feature_tail(prefix, nv, cfg)),
                     cuda_ms(torch, lambda: tail.feature_tail_reference(prefix, nv, cfg), reps=10)))
    event_ms = float(np.mean([k for k, _ in runs]))
    plain_ms = float(np.mean([p for _, p in runs]))
    kernels, busy, _, _ = profile_step(torch, lambda: tail.feature_tail_reference(prefix, nv, cfg), None)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    _, _, kernel_ms, _ = profile_step(
        torch, lambda: (flush.zero_(), tail.feature_tail(prefix, nv, cfg)), "tail_kernel")
    timed = "of device time"
    if kernel_ms is None:
        kernel_ms, timed = event_ms, "by CUDA events (the wrapper's host time included)"
    B, F = prefix.shape[:2]
    bound_ms, bound_by = tail_bound(cfg, B, F, int(nv.sum()))
    print(f"  feature-tail kernel: {kernel_ms:.4f} ms {timed}, L2 flushed "
          f"({bound_ms / kernel_ms * 100:.1f}% of bound); CUDA events {event_ms:.4f} ms "
          f"({runs[0][0]:.4f}, {runs[1][0]:.4f}) {tag}")
    print(f"  plain version (the torch epilogue): {plain_ms:.4f} ms ({runs[0][1]:.4f}, "
          f"{runs[1][1]:.4f}); its device time {busy:.4f} ms in {kernels:.0f} kernels {tag}")
    print("  library: none (no single PyTorch call computes the cepstral tail)")
    return dict(launches=launches["tail"], max_abs_err=errs["max_abs"], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def tail_paths(torch, counters, tag: str) -> None:
    """Phase 19: the feature tail's branches at b16 through
    fused_logmel_stages(feature_tail=True), counted, each against its plain
    version on the same prefix: utterance CMVN with and without variance
    normalization, one delta order, no energy, the Kaldi energy floor; rows
    at n_valid 0, 1, 2 and the tile edges, a zero row and a 100 Hz tone
    (period = hop, near-constant frames)."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend, tail
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    n = 16000 * SECONDS
    g = np.random.default_rng(26)
    extra = B_SMALL - len(TAIL_LENGTHS) - 2
    utts = [g.standard_normal(x) * 3000 for x in TAIL_LENGTHS + [n - 571 * i for i in range(extra)]]
    utts += [np.zeros(n), 3000 * np.sin(2 * np.pi * 100 * np.arange(n) / 16000)]
    print(f"== 19. the feature tail's branches, b{B_SMALL} x {SECONDS} s (lengths {TAIL_LENGTHS}, "
          f"full rows, a zero row, a 100 Hz tone)")
    for name, over in TAIL_CASES:
        cfg = named_config(name).replace(**over)
        batch = pad_batch(utts, cfg, bucket_len=n, dtype="int16")
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        counters.zero()
        st = frontend.fused_logmel_stages(audio, lengths, cfg, feature_tail=True)
        torch.cuda.synchronize()
        counters.expect(f"{name} {over}", frontend=1, tail=1,
                        **({"tail_cmvn": 1} if cfg.cmvn == "utterance" else {}),
                        **({"conditioning": 1} if chain.needs_conditioning(cfg) else {}))
        got, nv = st["features_fused"], st["n_valid"]
        prefix = frontend.logmel_prefix(audio, lengths, cfg)
        want = tail.feature_tail_reference(prefix, nv, cfg)
        scale = None
        if cfg.cmvn == "utterance" and cfg.cmvn_var_norm:
            pre = tail.feature_tail_reference(prefix, nv, cfg.replace(cmvn="off"))
            scale = testing.cmvn_column_scale(pre, nv, cfg.cmvn_eps)
            print(f"   {int((scale < 1).sum())} of {scale.size} utterance columns have sd < 1: held "
                  "before the division")
        errs = testing.tail_errors(got, want, scale)
        print(f"   {name} {over}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
        check(not testing.tail_failures(errs), f"{name} {over}: the tail within its gate of the plain version")
        cpu_nv = chain.num_valid_frames(torch.as_tensor(batch.lengths), cfg)
        check(torch.equal(st["frame_mask"].cpu(), chain.frame_mask(cpu_nv, got.shape[1], torch.float32))
              and torch.equal(st["n_valid"].cpu(), cpu_nv.to(torch.int32)),
              "the kernel's n_valid and mask equal to the CPU chain's")
        want_nv, want_mask = frontend.frame_counts_reference(lengths, cfg, got.shape[1])
        check(torch.equal(st["n_valid"], want_nv) and torch.equal(st["frame_mask"], want_mask),
              "and to chain.num_valid_frames / frame_mask on the same card lengths, bitwise")
        check(bool((got[st["frame_mask"] == 0] == 0).all()), "pad rows exactly 0")


def load_breakdown():
    """scripts/frontend_breakdown.py as a module (its cut builds and timing)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "scripts" / "frontend_breakdown.py"
    spec = importlib.util.spec_from_file_location("frontend_breakdown", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16x3_path(torch, counters, tag: str, breakdown, cuts: dict, lib_path) -> dict:
    """Phase 20: the bf16x3 form, classic13 b64 x 10 s through
    fused_logmel_stages(dft_passes="bf16x3"), counted: against its plain
    version (loud bins 1e-3, the other prefix gates) and the float64 plain
    version (loud bins 1e-3); the instantiation's SASS (HGMMA, the bulk
    copies, no HMMA); timed beside the Stockham form on the same rows, in
    turns, and cut after staging and before the projection (`cuts`, from
    scripts/frontend_breakdown.py); kaldi_mfcc with dither 1.0 at n_fft 404,
    b16."""
    from mfcc_tpu_torch.kernels import _build
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    cfg = named_config("classic13")
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 571, seed=0)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    kp, nbp = frontend.bf16_dims(cfg)
    tile, stages = frontend.bf16_plan(cfg)
    print(f"== 20. the bf16x3 form: classic13 b{B} x {SECONDS} s int16 [{B}, {T}], matrix "
          f"[{kp}, {2 * nbp}] bf16 x 2 in {kp // 16 * nbp // 136} ring chunks of 17,408 B, {tile} "
          f"frames a block, {stages} ring stages, {frontend.smem_bytes(cfg, 'bf16x3')} B of shared "
          f"memory a block")
    ops = breakdown.sass_opcodes(lib_path, _build.nvcc(), breakdown.BF16X3)
    print(f"  SASS of the int16 bf16x3 instantiation: HGMMA {ops.get('HGMMA', 0)}, UBLKCP "
          f"{ops.get('UBLKCP', 0)}, HMMA {ops.get('HMMA', 0)}, {sum(ops.values())} instructions")
    check(ops.get("HGMMA", 0) > 0 and ops.get("UBLKCP", 0) > 0 and ops.get("HMMA", 0) == 0,
          "the bf16x3 form runs wgmma (HGMMA) on bulk-copied stages, and no mma.sync (HMMA)")
    counters.zero()
    st = frontend.fused_logmel_stages(audio, lengths, cfg, dft_passes="bf16x3")
    torch.cuda.synchronize()
    launches = counters.expect("fused_logmel_stages(dft_passes='bf16x3')", frontend=1, bf16x3=1)
    got = st["prefix"]
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
    errs = testing.prefix_errors(got, plain, M)
    print("  kernel vs its plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    fails = testing.prefix_failures(errs, testing.BF16X3_LOUD_ATOL)
    check(not fails, f"bf16x3 kernel within its gates of the plain version {fails or ''}")
    del plain
    f64 = frontend.logmel_prefix_reference(audio, lengths, cfg.replace(dtype="float64"))
    e64 = testing.prefix_errors(got, f64, M)
    print("  kernel vs the float64 plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in e64.items()))
    check(e64["logmel_loud_max_abs"] < testing.BF16X3_LOUD_ATOL, "loud bins within 1e-3 of float64")
    del f64
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes="bf16x3")),
          "int16 rows == the same rows in float32, bitwise")
    check_counts(torch, frontend, audio, lengths, cfg, "bf16x3 classic13", "bf16x3")

    print(f"  times {tag}")
    runs = []
    for _ in range(2):  # in turns: bf16x3, Stockham, bf16x3, Stockham
        runs.append((cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")),
                     cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))))
    kernel_ms = float(np.mean([k for k, _ in runs]))
    r2_ms = float(np.mean([r for _, r in runs]))
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg,
                                                                       dft_passes="bf16x3"), reps=10)
    st = chain.logmel_stages(audio, lengths, cfg)
    framed = torch.nn.functional.pad(st["windowed"].reshape(B * F, -1), (0, cfg.n_fft - cfg.frame_length))
    framed = framed.contiguous()
    del st
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
    del framed
    lens = np.minimum(batch.lengths.astype(np.int64), T)
    frames = int(sum(min(F, math.ceil(x / cfg.frame_step)) for x in lens))
    matrix_bytes = 2 * kp * 2 * nbp * 2
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, B, F) + matrix_bytes,
                               frontend_ops(cfg, chain, frontend, torch, lens, F))
    tensor_ms = 3 * 2 * kp * 2 * cfg.n_bins * frames / PEAK_BF16_FLOPS * 1e3
    print(f"  bf16x3 kernel: {kernel_ms:.4f} ms ({runs[0][0]:.4f}, {runs[1][0]:.4f}; "
          f"{bound_ms / kernel_ms * 100:.1f}% of the function's bound) {tag}")
    print(f"  Stockham form on the same rows: {r2_ms:.4f} ms ({runs[0][1]:.4f}, {runs[1][1]:.4f}); "
          f"bf16x3 / Stockham = {kernel_ms / r2_ms:.2f} {tag}")
    print(f"  the three bf16 passes alone: 3 x 2 x {kp} x {2 * cfg.n_bins} FLOP x {frames} frames "
          f"-> {tensor_ms:.4f} ms at {PEAK_BF16_FLOPS / 1e12:.1f} TFLOP/s bf16")
    ms = breakdown.time_cuts(torch, frontend, cuts, cfg, audio, lengths, "bf16x3",
                             timer=lambda fn: device_ms(torch, fn, "logmel_kernel"))
    p0, p1, p2 = (float(np.mean(ms[c])) for c in (0, 1, 2))
    print(f"  breakdown (profiler device time, L2 flushed, cuts in turns): staging {p1:.4f} ms, "
          f"tensor-core product and |X|^2 {p2 - p1:.4f}, projection {p0 - p2:.4f}, whole {p0:.4f} "
          f"{tag}")
    print(f"  plain version (three fp32 matmuls of bf16 parts): {plain_ms:.4f} ms; torch.fft.rfft on "
          f"[{B * F}, {cfg.n_fft}] (DFT only): {rfft_ms:.4f} ms {tag}")
    del audio, lengths

    cfg = named_config("kaldi_mfcc").replace(dither=1.0, n_fft=404)
    batch = make_batch(pad_batch, cfg, B_SMALL, n, 571, seed=27)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")
    torch.cuda.synchronize()
    counters.expect("kaldi_mfcc n_fft 404 bf16x3", frontend=1, bf16x3=1, conditioning=1, dither=1)
    e = testing.prefix_errors(got, frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3"),
                              cfg.n_mels, cfg.log_kind)
    print(f"   kaldi_mfcc dither 1.0, n_fft 404, b{B_SMALL}: " + ", ".join(f"{k}={v:.3e}" for k, v in e.items()))
    fails = testing.prefix_failures(e, testing.BF16X3_LOUD_ATOL)
    check(not fails, f"bf16x3 with conditioning and dither within its gates {fails or ''}")
    return dict(launches=launches["bf16x3"], max_abs_err=errs["max_abs"], ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms)


def large_fft_path(torch, counters, tag: str) -> None:
    """Phase 21: classic13 at n_fft 2048 (26 filters; its dense mel matrix
    was over the block's shared memory, its 1,915 packed weights are not),
    b16: the Stockham form at 1,024 points against the float64 plain
    version, the bitwise invariances, extract_batch counted and within 5e-4
    of the CPU chain and the float64 chain; timed."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend

    cfg = named_config("classic13").replace(n_fft=2048)
    n16 = 16000 * SECONDS
    print(f"== 21. n_fft 2048: classic13 b{B_SMALL} x {SECONDS} s, radices "
          f"{frontend.radices(cfg.n_fft)}, {frontend.packed_count(cfg)} packed weights")
    lens = [n16 - 571 * i for i in range(B_SMALL)]
    _, audio, lengths, _, _ = small_path(torch, counters, cfg, lens, n16, 28, "classic13 n_fft 2048",
                                         testing.FEATURE_ATOL, prefix64=True)
    print(f"  frontend kernel at n_fft 2048, b{B_SMALL}: "
          f"{cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg)):.4f} ms {tag}")


def occupancy(frontend, named_config) -> None:
    """Phase 2's view of the front-end's instantiations from the card
    (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor):
    registers, local (spilled) bytes and blocks an SM of each of the 16
    FFT-form ones (int16 or float32 rows, plain or fused resample, dither,
    conditioning; the Stockham and Bluestein forms share them), of the 8
    block-plan ones (the plain form only, at n_fft 1102) and of the 8
    bf16x3 ones (the plain form only), at the shared memory of a
    config that takes it; then the named configs' blocks an SM and the
    Bluestein form's at n_fft 404 and 551. Fails on a spill, under three
    blocks an SM for classic13, logmel80 or whisper80, or under two for the
    Bluestein form at 404 (the designs' targets)."""
    print("  FFT-form instantiations (rows, resample, dither, conditioning): registers, "
          "local bytes, blocks an SM at that config's shared memory")
    for int16 in (True, False):
        for resample in (False, True):
            for dith in (False, True):
                for cond in (False, True):
                    cfg = named_config("kaldi_mfcc" if cond else "classic13")
                    cfg = cfg.replace(dither=1.0 if dith else 0.0,
                                      input_sample_rate=48000 if resample else None)
                    info = frontend.kernel_info(cfg, int16)
                    print(f"    {'int16' if int16 else 'float32'}, resample {int(resample)}, "
                          f"dither {int(dith)}, conditioning {int(cond)}: {info}")
                    check(info["local_bytes"] == 0, "no spills")
                    check(info["registers"] <= 80, "80 registers or fewer (three blocks an SM)")
    for name in ("classic13_deltas", "logmel80", "whisper80", "ssc26", "kaldi_plp",
                 "kaldi_spectrogram", "kaldi_mfcc", "mfcc39_48k", "mfcc39_44k"):
        cfg = named_config(name)
        info = frontend.kernel_info(cfg)
        print(f"    {name}: {info['smem_bytes']} B of shared memory a block, "
              f"{info['blocks_per_sm']} blocks an SM, {info['registers']} registers")
        if name in ("classic13_deltas", "logmel80", "whisper80"):
            check(info["blocks_per_sm"] >= 3, f"{name}: three blocks an SM or more")
    info = frontend.kernel_info(named_config("kaldi_mfcc").replace(dither=1.0))
    print(f"    kaldi_mfcc, dither 1.0: {info['smem_bytes']} B of shared memory a block, "
          f"{info['blocks_per_sm']} blocks an SM, {info['registers']} registers, "
          f"{info['local_bytes']} local bytes")
    check(info["blocks_per_sm"] >= 3, "kaldi_mfcc with dither 1.0 (the dither in the signal row): "
                                      "three blocks an SM or more")
    print("  the fused resample's instantiations: int16 rows stage their window as int16 over the "
          "warps' rows; float32 rows widen it")
    for name, blocks in (("mfcc39_48k", 3), ("mfcc39_44k", 2)):
        for int16 in (True, False):
            info = frontend.kernel_info(named_config(name), int16)
            print(f"    {name}, {'int16' if int16 else 'float32'} rows: {info['smem_bytes']} B of shared "
                  f"memory a block, {info['blocks_per_sm']} blocks an SM, {info['registers']} "
                  f"registers, {info['local_bytes']} local bytes")
            if int16:
                check(info["blocks_per_sm"] >= blocks, f"{name}, int16 rows: {blocks} blocks an SM or more")
    for n_fft in (404, 551):
        cfg = named_config("classic13").replace(n_fft=n_fft)
        info = frontend.kernel_info(cfg)
        print(f"    classic13 n_fft {n_fft} ({frontend.dft_form(cfg)}, P "
              f"{frontend.bluestein_dims(n_fft)[2]}): {info['smem_bytes']} B of shared memory a block, "
              f"{info['blocks_per_sm']} blocks an SM, {info['registers']} registers")
        if n_fft == 404:
            check(info["blocks_per_sm"] >= 2, "the Bluestein form at n_fft 404: two blocks an SM or more")
            info = frontend.kernel_info(cfg.replace(dither=1.0))
            print(f"    classic13 n_fft 404, dither 1.0: {info['smem_bytes']} B of shared memory a block, "
                  f"{info['blocks_per_sm']} blocks an SM, {info['registers']} registers")
    print("  block-plan instantiations (rows, dither, conditioning) at n_fft 1102: registers, local "
          "bytes, blocks an SM at that config's shared memory (plan, frames a block at once)")
    for int16 in (True, False):
        for dith in (False, True):
            for cond in (False, True):
                cfg = named_config("kaldi_mfcc" if cond else "classic13").replace(
                    n_fft=1102, dither=1.0 if dith else 0.0)
                info = frontend.kernel_info(cfg, int16)
                print(f"    {'int16' if int16 else 'float32'}, dither {int(dith)}, conditioning "
                      f"{int(cond)}: {info}, {frontend.fft_layout(cfg)}")
                check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, "no spills, launchable")
    print("  bf16x3 instantiations (rows, dither, conditioning): registers, local bytes, blocks an SM "
          "at that config's shared memory (frames a block, ring stages)")
    for int16 in (True, False):
        for dith in (False, True):
            for cond in (False, True):
                cfg = named_config("kaldi_mfcc" if cond else "classic13").replace(dither=1.0 if dith else 0.0)
                info = frontend.kernel_info(cfg, int16, "bf16x3")
                print(f"    {'int16' if int16 else 'float32'}, dither {int(dith)}, conditioning "
                      f"{int(cond)}: {info}, plan {frontend.bf16_plan(cfg)}")
                check(info["local_bytes"] == 0, "no spills")
    print("  bf16x3 fused-resample instantiations at 48 kHz (rows, dither, conditioning): the input "
          "window over the power rows, the taps after them")
    for int16 in (True, False):
        for dith in (False, True):
            for cond in (False, True):
                cfg = named_config("kaldi_mfcc" if cond else "classic13").replace(
                    dither=1.0 if dith else 0.0, input_sample_rate=48000)
                check(frontend.resample_route(cfg, "bf16x3") == "fused", "the fused route")
                info = frontend.kernel_info(cfg, int16, "bf16x3")
                print(f"    {'int16' if int16 else 'float32'}, dither {int(dith)}, conditioning "
                      f"{int(cond)}: {info}, plan {frontend.bf16_plan(cfg, int16)}")
                check(info["local_bytes"] == 0, "no spills")
    print("  bf16x3 block-plan instantiations (rows, dither, conditioning) at n_fft 4096: registers, "
          "local bytes, blocks an SM at that config's shared memory (plan, frames a block, ring stages)")
    for int16 in (True, False):
        for dith in (False, True):
            for cond in (False, True):
                cfg = named_config("kaldi_mfcc" if cond else "classic13").replace(
                    n_fft=4096, dither=1.0 if dith else 0.0)
                info = frontend.kernel_info(cfg, int16, "bf16x3")
                print(f"    {'int16' if int16 else 'float32'}, dither {int(dith)}, conditioning "
                      f"{int(cond)}: {info}, {frontend.bf16_layout(cfg, int16)}")
                check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, "no spills, launchable")


CORPUS_FILES = 256  # 16 kHz PCM16 files of 1-10 s
CORPUS_LONG_S = (75, 90)  # files over the 10 s top bucket: split / stitched
CORPUS_48K_FILES, CORPUS_48K_LONG_S = 32, 90
CMVN_GATE = 1e-3  # the normalized corpus: |mean| and |std - 1| per dimension


def write_corpus(wav, root, n_files: int, sr: int, long_s, seed: int, extra: bool) -> list[str]:
    """PCM16 files of 1-10 s (noise under a slow random envelope, so the log
    energy varies), every fourth in a speaker subdirectory, plus files of
    long_s seconds; with extra, a corrupt file and one at 8 kHz."""
    g = np.random.default_rng(seed)
    root.mkdir(parents=True)
    paths = []
    for i, n in enumerate([int(s * sr) for s in g.uniform(1.0, 10.0, n_files)] + [s * sr for s in long_s]):
        d = root / f"spk{i % 3}" if i % 4 == 0 else root
        d.mkdir(exist_ok=True)
        env = np.repeat(g.uniform(0.05, 1.0, n // 1600 + 1), 1600)[:n]
        p = d / f"u{i:04d}.wav"
        wav.write_wav(p, sr, (g.standard_normal(n) * 6000 * env).astype(np.int16))
        paths.append(str(p))
    if extra:
        (root / "corrupt.wav").write_bytes(b"RIFF\x10\x00\x00\x00WAVEfmt ")
        wav.write_wav(root / "rate8k.wav", 8000, np.zeros(8000, np.int16))
    return paths


def cli_run(torch, cli, args: list[str], metrics) -> tuple[float, dict]:
    """`cli.main(["extract", ...])` through a synchronize: (wall seconds, the
    metrics file's "done" line)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["extract", *args, "--metrics", str(metrics)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"extract {' '.join(a for a in args if not a.startswith('/'))}: exit 0")
    return wall, json.loads(metrics.read_text().splitlines()[-1])


def corpus_path(torch, counters, tag: str, seed: int, tmp) -> None:
    """Phase 22: the corpus path, `python -m mfcc_tpu_torch.cli extract` and
    `apply-cmvn`, and the multi-process feed, on corpora the script writes
    into tmp (see the module docstring); the npz shards of (a) stay in
    tmp / "a" for phase 25."""
    from mfcc_tpu_torch import cli, named_config, parallel
    from mfcc_tpu_torch import io as io_mod
    from mfcc_tpu_torch import pipeline as pipeline_mod
    from mfcc_tpu_torch.io import ShardWriter, read_ark, read_htk, read_shard, read_wav, stream_batches_direct, wav
    from mfcc_tpu_torch.io.htk import energy_last_permutation
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.ops import resample as R
    from mfcc_tpu_torch.parallel import CmvnAccumulator
    from mfcc_tpu_torch.pipeline import longform, pad_batch
    from mfcc_tpu_torch.testing import RESAMPLED_FEATURE_ATOL, RESAMPLED_FEATURE_RTOL

    print(f"== 22. the corpus path: python -m mfcc_tpu_torch.cli extract / apply-cmvn (seed {seed})")
    t_phase = time.perf_counter()
    files = write_corpus(wav, tmp / "c16", CORPUS_FILES, 16000, CORPUS_LONG_S, seed, True)
    files48 = write_corpus(wav, tmp / "c48", CORPUS_48K_FILES, 48000, (CORPUS_48K_LONG_S,), seed + 1, False)
    audio_s = sum(read_wav(p)[1].shape[0] for p in files) / 16000
    print(f"  corpus: {len(files)} files at 16 kHz ({audio_s:.1f} audio-s; two of "
          f"{CORPUS_LONG_S} s), a corrupt file, one at 8 kHz; {len(files48)} at 48 kHz (one of "
          f"{CORPUS_48K_LONG_S} s); written in {time.perf_counter() - t_phase:.1f} s")
    cfg = named_config("classic13_deltas")
    # the batches of the run, from the feed's headers (no decode)
    plan = list(stream_batches_direct(sorted(files), cfg, skip_ids=frozenset(files)))
    seg_frames = int(10.0 * cfg.sample_rate) // cfg.frame_step
    groups = [math.ceil(len(longform.segment_plan(s * 16000, cfg, seg_frames)[0]) / 8)
              for s in CORPUS_LONG_S]

    # (a) extract on the card, counted; where its wall time goes: the
    # feed (decode into the rows, the consumer waiting on the next
    # batch), sharded_extract_batch (host wall, and device span by
    # events), the long files, the shard writes (writer threads)
    spans, host = [], {"feed": 0.0, "long files": 0.0, "writes (thread time)": 0.0}
    inner = parallel.sharded_extract_batch
    inner_feed, inner_long = io_mod.stream_batches_direct, pipeline_mod.extract_long
    inner_write = ShardWriter.write

    def timed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(*a, **k)
        end.record()
        spans.append((start, end, time.perf_counter() - t0))
        return out

    def timed_feed(*a, **k):
        it = inner_feed(*a, **k)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            host["feed"] += time.perf_counter() - t0
            if b is None:
                return
            yield b

    def timed_long(*a, **k):
        t0 = time.perf_counter()
        out = inner_long(*a, **k)
        torch.cuda.synchronize()
        host["long files"] += time.perf_counter() - t0
        return out

    def timed_write(self, *a, **k):
        t0 = time.perf_counter()
        out = inner_write(self, *a, **k)
        host["writes (thread time)"] += time.perf_counter() - t0
        return out

    parallel.sharded_extract_batch, io_mod.stream_batches_direct = timed, timed_feed
    pipeline_mod.extract_long, ShardWriter.write = timed_long, timed_write
    try:
        counters.zero()
        wall, done = cli_run(torch, cli, [str(tmp / "c16"), "-o", str(tmp / "a"), "--config",
                                          "classic13_deltas", "--feed", "direct"], tmp / "a.jsonl")
        launches = counters.read()
    finally:
        parallel.sharded_extract_batch, io_mod.stream_batches_direct = inner, inner_feed
        pipeline_mod.extract_long, ShardWriter.write = inner_long, inner_write
    shards = sorted((tmp / "a").glob("h0-*.npz"))
    n_long = sum("long" in p.name for p in shards)
    print(f"  (a) {len(shards)} shards ({len(plan)} batches + {n_long} long files), "
          f"{int(done['utterances'])} utterances, decode errors {int(done['decode_errors'])}, "
          f"wrong rate {int(done['wrong_rate'])}, long split {int(done['long_split'])}; launches {launches}")
    check(len(shards) == len(plan) + len(CORPUS_LONG_S) and n_long == len(CORPUS_LONG_S),
          "one shard a batch and one a long file")
    check((done["decode_errors"], done["wrong_rate"], done["long_split"]) == (1, 1, len(CORPUS_LONG_S)),
          "the corrupt file and the 8 kHz file are counted, the long files split")
    check(launches["frontend"] == len(plan) + sum(groups)
          and launches["tail"] == len(plan) + len(CORPUS_LONG_S)
          and not any(v for k, v in launches.items() if k not in ("frontend", "tail")),
          f"front-end launches {launches['frontend']} == {len(plan)} batches + {sum(groups)} segment "
          f"groups; tail launches {launches['tail']} == batches + long files; no other kernel")
    got = {}
    for p in shards:
        got.update(read_shard(p))
    check(sorted(got) == sorted(files), f"every one of the {len(files)} files in a shard, once")
    worst, shapes = 0.0, []
    for path, feat in got.items():
        ref = chain.extract_single(read_wav(path)[1], cfg, device="cpu").numpy()
        if feat.shape != ref.shape:
            shapes.append(f"{path}: {feat.shape} != {ref.shape}")
            continue
        worst = max(worst, float(np.abs(feat - ref).max()))
    check(not shapes, f"every utterance has the CPU chain's frames {shapes[:3]}")
    print(f"  max |card - CPU chain extract_single| over every utterance: {worst:.3e}")
    check(worst <= 5e-4, "every utterance within 5e-4 of the CPU chain")
    busy = sum(s.elapsed_time(e) for s, e, _ in spans) / 1e3
    print(f"  (f) corpus extract, decode and writes included: {audio_s:.1f} audio-s in {wall:.3f} s "
          f"wall = {audio_s / wall:.0f} audio-s/s {tag}")
    in_call = sum(h for _, _, h in spans)
    print(f"      in sharded_extract_batch ({len(spans)} calls): {in_call:.3f} s of host wall "
          f"({in_call / wall * 100:.1f}%), {busy:.4f} s of device span from its first copy to its "
          f"last kernel ({busy / wall * 100:.1f}% of the wall) {tag}")
    print("      " + ", ".join(f"{k} {v:.3f} s ({v / wall * 100:.1f}%)" for k, v in host.items())
          + f" {tag}")

    # (b) the two-pass global CMVN, on the card and on the CPU
    moments = {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"g_{dev}"
        cli_run(torch, cli, [str(tmp / "c16"), "-o", str(out), "--config", "classic13_deltas_gcmvn",
                             "--device", dev, "--cmvn-stats", str(tmp / f"m_{dev}.npz")], tmp / "g.jsonl")
        moments[dev] = CmvnAccumulator.load(tmp / f"m_{dev}.npz")
    g, c = moments["cuda"], moments["cpu"]
    # a column's sums relative to its scale: sqrt(n Σx²) bounds Σ|x|
    rel1 = float(np.max(np.abs(g.s1 - c.s1) / np.sqrt(c.n * c.s2)))
    rel2 = float(np.max(np.abs(g.s2 - c.s2) / c.s2))
    print(f"  (b) moments, card vs --device cpu: n {g.n:.0f} / {c.n:.0f}; max |ds1| / sqrt(n s2) "
          f"{rel1:.3e}, max |ds2| / s2 {rel2:.3e}")
    check(g.n == c.n and rel1 <= 1e-5 and rel2 <= 1e-5, "the moments within 1e-5 of the CPU run's")
    rc = cli.main(["apply-cmvn", str(tmp / "g_cuda"), "--stats", str(tmp / "m_cuda.npz"),
                   "--config", "classic13_deltas_gcmvn"])
    check(rc == 0, "apply-cmvn: exit 0")
    norm = np.concatenate([f for p in sorted((tmp / "g_cuda").glob("h0-*.npz"))
                           for f in read_shard(p).values()])
    mean_err = float(np.abs(norm.mean(axis=0)).max())
    std_err = float(np.abs(norm.std(axis=0) - 1.0).max())
    print(f"  normalized corpus ({norm.shape[0]} frames): max |mean| {mean_err:.3e}, "
          f"max |std - 1| {std_err:.3e}")
    check(mean_err <= CMVN_GATE and std_err <= CMVN_GATE,
          f"the normalized corpus has mean 0 and std 1 within {CMVN_GATE} per dimension")

    # (c) mfcc39_48k: batches through the fused form, the 90 s file
    # through resample.cu and the segmented front-end
    cfg48 = named_config("mfcc39_48k")
    counters.zero()
    cli_run(torch, cli, [str(tmp / "c48"), "-o", str(tmp / "r"), "--config", "mfcc39_48k",
                         "--feed", "direct"], tmp / "r.jsonl")
    launches = counters.read()
    print(f"  (c) mfcc39_48k launches: {launches}")
    check(launches["resample"] == 1, "the 90 s file resampled by resample.cu once")
    long48 = files48[-1]
    feat = read_shard(tmp / "r" / "h0-long-000000.npz")[long48]
    ref = chain.extract_single(read_wav(long48)[1], cfg48, device="cpu").numpy()
    err = float(np.abs(feat - ref).max())
    print(f"  the {CORPUS_48K_LONG_S} s file vs the CPU chain's monolithic extraction: {err:.3e}")
    check(feat.shape == ref.shape and np.allclose(feat, ref, atol=RESAMPLED_FEATURE_ATOL,
                                                  rtol=RESAMPLED_FEATURE_RTOL),
          f"within {RESAMPLED_FEATURE_ATOL} of it")
    x44 = torch.as_tensor(np.random.default_rng(seed).standard_normal((1, 44100 * 90)) * 3000,
                          dtype=torch.float32, device="cuda")
    n_out = R.output_length(x44.shape[1], 44100, 16000)
    k44_ms = cuda_ms(torch, lambda: R.resample_batch(x44, 44100, 16000), reps=10)
    p44_ms = cuda_ms(torch, lambda: R.resample_reference(x44, 44100, 16000), reps=3)
    d = R.polyphase_design(*R.ratio(44100, 16000))
    b44_ms, b44_by = bound(x44.numel() * 4 + n_out * 4 + d["up"] * d["K"] * 4,
                           resample_ops(R, *R.ratio(44100, 16000), [n_out]))
    print(f"  resample.cu, one {x44.shape[1]}-sample row (90 s) 44.1 -> 16 kHz: {k44_ms:.4f} ms "
          f"({b44_ms / k44_ms * 100:.1f}% of its {b44_ms:.4f} ms bound, {b44_by}); plain version "
          f"{p44_ms:.4f} ms; library: none {tag}")
    del x44

    # (d) HTK and Kaldi output equal to the npz run
    ref_feats = got
    perm = energy_last_permutation(cfg)
    for fmt in ("htk", "kaldi"):
        out = tmp / fmt
        cli_run(torch, cli, [str(tmp / "c16"), "-o", str(out), "--config", "classic13_deltas",
                             "--format", fmt], tmp / f"{fmt}.jsonl")
        back = {}
        for marker in sorted((out / "done").glob("h0-*.json")):
            meta = json.loads(marker.read_text())
            if fmt == "kaldi":
                back.update(read_ark(out / meta["files"][0]))
            else:
                for name in meta["files"]:
                    back[name] = read_htk(out / name)[0]
        if fmt == "htk":
            names = {f"{pathlib.Path(p).stem}-{hashlib.sha256(p.encode()).hexdigest()[:8]}.htk": p
                     for p in files}
            back = {names[k]: v for k, v in back.items()}
            inv = np.argsort(perm)
            back = {k: v[:, inv] for k, v in back.items()}
        same = sorted(back) == sorted(ref_feats) and all(
            np.array_equal(back[k], ref_feats[k]) for k in ref_feats)
        check(same, f"--format {fmt}: {len(back)} utterances read back equal to the npz run")

    # (e) no card visible: the CLI exits non-zero and writes no shard
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-m", "mfcc_tpu_torch.cli", "extract", str(tmp / "c16"),
                          "-o", str(tmp / "e"), "--device", "cuda"], env=env, capture_output=True,
                         text=True, timeout=120)
    wrote = list((tmp / "e").rglob("*.npz")) if (tmp / "e").exists() else []
    check(res.returncode != 0 and not wrote,
          f"with CUDA_VISIBLE_DEVICES='' --device cuda exits {res.returncode} and writes no shard")

    # (f) the host-fed step: pinned rows against pageable ones
    b = pad_batch([read_wav(p)[1] for p in files[:B]], cfg, bucket_len=160000, dtype="int16")
    pinned = torch.from_numpy(b.audio).pin_memory()
    lens_d = torch.as_tensor(b.lengths, device="cuda")

    def pinned_step():
        chain.extract_batch(pinned.to("cuda", non_blocking=True), lens_d, cfg)

    pageable = lambda: chain.extract_batch(b.audio, b.lengths, cfg)  # noqa: E731
    times = {"pinned": [], "pageable": []}
    for _ in range(3):
        for name, fn in (("pageable", pageable), ("pinned", pinned_step), ("pinned", pinned_step),
                         ("pageable", pageable)):
            times[name].append(host_ms(torch, fn, reps=3))
    pin_ms, page_ms = (float(np.median(times[k])) for k in ("pinned", "pageable"))
    rows_s = float(b.lengths.sum()) / 16000
    print(f"  (f) host-fed extract_batch step, b{B} int16 rows [{B}, {b.audio.shape[1]}] ({rows_s:.1f} "
          f"audio-s), host clock, in turns: pinned rows {pin_ms:.3f} ms, pageable rows {page_ms:.3f} ms "
          f"{tag}")

    # (g) the multi-process feed on the same corpus, counted: the launches
    # of (a) and the shards of its direct feed
    counters.zero()
    cli_run(torch, cli, [str(tmp / "c16"), "-o", str(tmp / "mp"), "--config", "classic13_deltas",
                         "--feed", "mp"], tmp / "mp.jsonl")
    launches = counters.read()
    print(f"  (g) --feed mp launches: {launches}")
    check(launches["frontend"] == len(plan) + sum(groups)
          and launches["tail"] == len(plan) + len(CORPUS_LONG_S)
          and not any(v for k, v in launches.items() if k not in ("frontend", "tail")),
          "--feed mp launches the front-end and the tail as the direct feed does, and nothing else")
    n = same_shards(tmp / "a", tmp / "mp")
    check(n == len(shards), f"--feed mp writes (a)'s {n} shards (npz members bytewise)")
    mp_feed_turns(torch, cli, io_mod, tmp, seed, tag)
    print(f"  phase 22 took {time.perf_counter() - t_phase:.1f} s")


BIG_FILES = 2048  # 16 kHz PCM16 files of 1-10 s: ~11,000 audio-s (~3 h), ~350 MB
FEED_TURNS = ("mp", "mp", "direct", "direct", "mp")  # the first warms the worker pool


def same_shards(a_dir, b_dir) -> int:
    """The number of npz shards of a_dir, checked equal in name and in their
    members' bytes to b_dir's (a zip's timestamps aside)."""
    import zipfile

    names = sorted(p.name for p in a_dir.glob("h0-*.npz"))
    check(names == sorted(p.name for p in b_dir.glob("h0-*.npz")), f"{b_dir.name}: the shards of {a_dir.name}")
    for name in names:
        with zipfile.ZipFile(a_dir / name) as za, zipfile.ZipFile(b_dir / name) as zb:
            if {m: za.read(m) for m in za.namelist()} != {m: zb.read(m) for m in zb.namelist()}:
                return -1
    return len(names)


def feeds_alone(torch, files: list[str], audio_s: float, tag: str) -> None:
    """Phase 22 (h), the feeds without the CLI: the header parse serially
    (the direct feed's) and through the worker pool (the mp feed's), and
    both feeds at the CLI's defaults with a fresh pinned row pool a run,
    each batch released as it comes. A warm-up of each, then two turns in
    the order a, b, ..., b, a; host clock."""
    from mfcc_tpu_torch import named_config
    from mfcc_tpu_torch.io import DecodeStats, SlabPool, reader
    from mfcc_tpu_torch.pipeline import RowPool

    cfg = named_config("classic13_deltas")
    kw = dict(batch_size=64, max_len_s=10.0, num_threads=FEED_THREADS, dtype="i16")

    def headers_serial():
        st = DecodeStats()
        for p in files:
            reader._parse_header_counted(p, 16000, st)

    def headers_pool():
        pool, private = reader.POOL_CACHE.acquire(FEED_THREADS)
        try:
            for _ in reader._mp_header_stream(files, pool, 16000, DecodeStats()):
                pass
        finally:
            reader.POOL_CACHE.release(pool, private)

    def feed(fn, **rows):
        def run():
            for b in fn(files, cfg, **kw, **{k: make() for k, make in rows.items()}):
                b.release()
        return run

    variants = {
        "headers, serial": headers_serial,
        "headers, pool": headers_pool,
        "direct, pinned": feed(reader.stream_batches_direct, pool=lambda: RowPool(pin=True)),
        "mp, pinned": feed(reader.stream_batches_mp, slabs=lambda: SlabPool(pin=True)),
    }
    walls = {name: [] for name in variants}
    for name, run in variants.items():  # warm-up
        run()
    for name in [*variants, *reversed(variants)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        variants[name]()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    print(f"      the feeds alone ({FEED_THREADS} threads / workers; no extraction, no writes; mean of two turns):")
    for name, ws in walls.items():
        wall = float(np.mean(ws))
        print(f"        {name:16s} {audio_s / wall:.0f} audio-s/s, {wall / len(files) * 1e6:.1f} us a file "
              f"(turns {', '.join(f'{w:.4f}' for w in ws)} s) {tag}")


FEED_THREADS = 4  # the CLI's --threads default


def mp_feed_turns(torch, cli, io_mod, tmp, seed: int, tag: str) -> None:
    """Phase 22 (h) and (i): the two feeds timed in turns on a corpus of
    BIG_FILES files, and `ShardDataset` over the shards (see the module
    docstring)."""
    import glob
    import shutil

    from mfcc_tpu_torch.io import ShardDataset, read_shard, wav
    from mfcc_tpu_torch.io.reader import _shm_dir

    t0 = time.perf_counter()
    files = write_corpus(wav, tmp / "big", BIG_FILES, 16000, (), seed + 2, False)
    audio_s = sum(wav.parse_file_header(p)[1] for p in files) / 16000
    size = sum(os.path.getsize(p) for p in files)
    print(f"  (h) {len(files)} PCM16 files of 1-10 s at 16 kHz: {audio_s:.1f} audio-s, {size / 1e6:.1f} MB, "
          f"written in {time.perf_counter() - t0:.1f} s")
    names = {"mp": "stream_batches_mp", "direct": "stream_batches_direct"}
    inner = {feed: getattr(io_mod, name) for feed, name in names.items()}
    waits = dict.fromkeys(names, 0.0)

    def waited(feed):
        """The feed, with the time the CLI waits on its next batch summed."""
        def stream(*a, **k):
            it = inner[feed](*a, **k)
            while True:
                t = time.perf_counter()
                b = next(it, None)
                waits[feed] += time.perf_counter() - t
                if b is None:
                    return
                yield b
        return stream

    runs = {feed: [] for feed in names}
    kept = {}
    for feed, name in names.items():
        setattr(io_mod, name, waited(feed))
    try:
        for i, feed in enumerate(FEED_TURNS):
            out = tmp / f"big_{i}_{feed}"
            waits[feed] = 0.0
            wall, done = cli_run(torch, cli, [str(tmp / "big"), "-o", str(out), "--config", "classic13_deltas",
                                              "--feed", feed], tmp / "big.jsonl")
            check(int(done["utterances"]) == len(files), f"run {i} ({feed}): every file in a shard")
            if i == 0:
                print(f"      warm-up ({feed}, the worker pool started): {wall:.3f} s")
            else:
                runs[feed].append((wall, waits[feed]))
                print(f"      turn {i} --feed {feed}: {audio_s / wall:.0f} audio-s/s ({wall:.3f} s), the feed "
                      f"{waits[feed] / wall * 100:.1f}% of the wall {tag}")
            if feed in kept:
                shutil.rmtree(kept[feed])
            kept[feed] = out
    finally:
        for feed, name in names.items():
            setattr(io_mod, name, inner[feed])
    for feed, rs in runs.items():
        wall = float(np.mean([w for w, _ in rs]))
        share = float(np.mean([f / w for w, f in rs]))
        print(f"      --feed {feed}: {audio_s / wall:.0f} audio-s/s (mean of {len(rs)} turns), the feed "
              f"{share * 100:.1f}% of the wall {tag}")
    n = same_shards(kept["direct"], kept["mp"])
    check(n >= len(files) // 64, f"the two feeds' {n} shards equal (npz members bytewise)")
    feeds_alone(torch, files, audio_s, tag)
    left = glob.glob(os.path.join(_shm_dir(), f"mfcc_tpu_torch_slab_{os.getpid()}_*"))
    check(not left, f"no slab file of this process's pools left in {_shm_dir()} {left[:3]}")

    # (i) ShardDataset over the mp feed's shards
    t0 = time.perf_counter()
    want = {}
    for p in sorted(kept["mp"].glob("h0-*.npz")):
        want.update(read_shard(p))
    ds = ShardDataset(kept["mp"])
    got = list(ds)
    check(len(ds) == len(got) == len(want) == len(files) and {k for k, _ in got} == set(want)
          and all(np.array_equal(f, want[k]) for k, f in got),
          f"(i) ShardDataset: {len(got)} utterances, each equal to read_shard's")
    check(ds.num_frames == sum(f.shape[0] for f in want.values()), f"{ds.num_frames} frames from the markers")
    parts = [ds.split(i, 4) for i in range(4)]
    keys = [k for part in parts for k, _ in part]
    check(sorted(keys) == sorted(want) and sum(len(part) for part in parts) == len(ds),
          "split(i, 4) partitions the set")
    shuffled = ShardDataset(kept["mp"], shuffle=True, seed=seed)
    e1, e2 = [k for k, _ in shuffled], [k for k, _ in shuffled]
    check(e1 != e2 and sorted(e1) == sorted(e2) == sorted(want), "two epochs give different orders of the set")
    print(f"      read {len(got)} utterances ({ds.num_frames} frames) three times in {time.perf_counter() - t0:.2f} s")


SERVE_STREAMS = 256  # docs/SERVE.md's default block on a 256-session box (SERVING_r04.json's rows)
SERVE_K = 16
SERVE_CHUNK_S = 0.16  # 2,560 samples a push at 16 kHz
SERVE_SECONDS = (1.0, 10.0)  # stream lengths, uniform
SERVE_SMALL = 16  # streams of each other streamable named config
SERVE_CONFIGS = ("classic13", "ssc26", "logmel80", "classic13_deltas_gcmvn", "mfcc39_48k",
                 "mfcc39_44k", "kaldi_mfcc", "kaldi_spectrogram", "kaldi_fbank", "kaldi_plp")
SERVE_SESSIONS = 8  # sessions of each `cli serve` run
SERVE_POOLS = (16, 64, 256)  # pool sizes of the readings
SERVE_STAGGER = 8  # session i opens on turn i mod 8 (drive_pool, serve_requests)


def stream_signals(cfg, n: int, lo_s: float, hi_s: float, seed: int) -> list:
    """n int16-valued float32 signals at cfg's input rate, lengths uniform in
    [lo_s, hi_s) seconds: noise under a slow random envelope."""
    sr = cfg.input_sample_rate or cfg.sample_rate
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(g.uniform(lo_s, hi_s) * sr)
        env = np.repeat(g.uniform(0.05, 1.0, m // 800 + 1), 800)[:m]
        out.append(np.round(g.standard_normal(m) * 6000 * env).clip(-32768, 32767).astype(np.float32))
    return out


def drive_pool(pool, xs: list, chunk: int, stagger: int = SERVE_STAGGER) -> list:
    """Opens session i on turn i mod `stagger` (staggered arrivals: a round
    then holds first and inner windows), pushes `chunk` samples to every
    live session in turn and polls after each turn, ends a session when its
    signal is pushed; returns each signal's concatenated features."""
    sids = [None] * len(xs)
    pos = [0] * len(xs)
    got = {}
    turn = 0
    while turn < stagger or pool.n_active:
        for i in range(len(xs)):
            if sids[i] is None and i % stagger == turn:
                sids[i] = pool.open()
                got[sids[i]] = []
            if sids[i] is None or pos[i] is None:
                continue
            if pos[i] < len(xs[i]):
                pool.push(sids[i], xs[i][pos[i] : pos[i] + chunk])
                pos[i] += chunk
            if pos[i] >= len(xs[i]):
                pool.end(sids[i])
                pos[i] = None
        for s, f in pool.poll().items():
            got[s].append(f)
        turn += 1
    return [np.concatenate(got[s]) if got[s] else np.zeros((0, pool.cfg.feat_dim), np.float32)
            for s in sids]


def counted_rounds(pool, counters) -> list:
    """Wraps the pool's rounds: every count is set to 0 just before a round
    and read just after it; returns the list that collects (counts, the
    round's result) a round."""
    inner, rounds = pool._engine.round, []

    def round_(entries):
        counters.zero()
        res = inner(entries)
        rounds.append((counters.read(), res))
        return res

    pool._engine.round = round_
    return rounds


def check_rounds(rounds, cfg, frontend, what: str) -> dict:
    """Each round: the front-end's block form once where a stream had a
    block (its conditioning, PLP, spectrogram or SSC branch with it where
    cfg takes one), the tail once a finalize group for mfcc configs, and no
    other kernel of the port. Returns the counted launches: the block's in
    all and its most in a round, the tail's in all, its most in a round and
    the rounds that took two."""
    from mfcc_tpu_torch.ops import chain

    kind = frontend.feature_kind(cfg)
    cond = int(chain.needs_conditioning(cfg))
    bad = []
    for counts, res in rounds:
        b = res.base_launches
        want = {"block": b, "conditioning": cond * b, "plp": b * (kind == "plp"),
                "spectrogram": b * (kind == "spectrogram"), "ssc": b * (kind == "ssc"),
                "tail": res.fin_launches if cfg.features == "mfcc" else 0}
        want = {k: want.get(k, 0) for k in counts}
        if counts != want or b > 1 or res.fin_launches > 2:
            bad.append((counts, b, res.fin_launches))
    n = dict(blocks=sum(c["block"] for c, _ in rounds),
             block_max=max((c["block"] for c, _ in rounds), default=0),
             tails=sum(c["tail"] for c, _ in rounds),
             tail_max=max((c["tail"] for c, _ in rounds), default=0),
             two_tail_rounds=sum(c["tail"] == 2 for c, _ in rounds))
    check(not bad and n["blocks"] > 0,
          f"{what}: {len(rounds)} rounds, each the front-end's block form once where a block was "
          f"ready and at most two finalize launches, no other kernel of the port ({n['blocks']} block "
          f"launches, at most {n['block_max']} a round; {n['tails']} tail launches, at most "
          f"{n['tail_max']} a round, two in {n['two_tail_rounds']} rounds) {bad[:3] if bad else ''}")
    return n


def stream_gate(testing, cfg, got, want, what: str) -> float:
    """Streamed features against the offline chain's under cfg's gate: 5e-4
    (8e-4 resampled; the Kaldi mfcc / fbank gates), the two-regime log-mel
    gate for log-mel features, the family gates for PLP, spectrogram and
    SSC. Returns the max |diff|."""
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) if got.size else 0.0
    if cfg.features in testing.FAMILY_GATES:
        errs = testing.family_feature_errors(got, want, cfg.features, "fp32")
        fails = testing.family_feature_failures(errs, cfg.features, "fp32")
    elif cfg.features == "logmel":
        errs = testing.logmel_errors(got, want, cfg.log_kind)
        fails = testing.logmel_failures(errs)
    else:
        atol = (testing.RESAMPLED_FEATURE_ATOL if cfg.input_sample_rate
                else testing.kaldi_feature_atol(cfg) if cfg.window == "povey" else testing.FEATURE_ATOL)
        errs, fails = {"max_abs": err}, ([] if err <= atol else [f"max_abs {err:.3e} > {atol}"])
    print(f"  {what}: " + ", ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    check(not fails, f"{what}: within the gate {fails or ''}")
    return err


def offline_features(torch, chain, pad_batch, cfg, xs) -> list:
    """The card's offline extract_batch of each whole signal, trimmed to its
    frames."""
    b = pad_batch([x.astype(np.int16) for x in xs], cfg, dtype="int16")
    feat, _ = chain.extract_batch(b.audio, b.lengths, cfg)
    feat = feat.cpu().numpy()
    return [feat[i, : cfg.num_frames(chain.valid_length(len(x), cfg))] for i, x in enumerate(xs)]


def open_order(n: int) -> list:
    """The sessions in the order they open under the staggered schedule
    (session i on turn i mod SERVE_STAGGER): a server numbers its sids
    0, 1, ... in that order."""
    return sorted(range(n), key=lambda i: (i % SERVE_STAGGER, i))


def serve_requests(xs: list, chunk: int, wire: str) -> bytes:
    """The request stream of a `cli serve` client: session i opened on turn
    i mod SERVE_STAGGER (sids in the order of the opens), the open
    sessions' int16 chunks pushed in turns, each session ended after its
    last push; EOF follows."""
    import base64
    import struct

    def msg(obj, payload=b""):
        if wire == "jsonl":
            if payload:
                obj = {**obj, "pcm16": base64.b64encode(payload).decode()}
            return (json.dumps(obj) + "\n").encode()
        head = json.dumps(obj).encode()
        return struct.pack("<I", len(head)) + head + struct.pack("<I", len(payload)) + payload

    out = []
    pos = [0] * len(xs)
    sid = {i: k for k, i in enumerate(open_order(len(xs)))}
    turn = 0
    while turn < SERVE_STAGGER or any(p is not None for p in pos):
        for i, x in enumerate(xs):
            if i % SERVE_STAGGER == turn:  # session i opens on turn i mod SERVE_STAGGER
                out.append(msg({"op": "open", "id": f"s{i}"}))
            if turn < i % SERVE_STAGGER or pos[i] is None:
                continue
            pcm = x[pos[i] : pos[i] + chunk].astype("<i2").tobytes()
            out.append(msg({"op": "push", "sid": sid[i]}, pcm))
            pos[i] += chunk
            if pos[i] >= len(x):
                out.append(msg({"op": "end", "sid": sid[i]}))
                pos[i] = None
        turn += 1
    return b"".join(out)


def serve_events(raw: bytes, wire: str) -> list:
    """The (header, payload) events of a `cli serve` run's stdout."""
    import base64
    import struct

    if wire == "jsonl":
        out = []
        for line in raw.decode().splitlines():
            if line.strip():
                ev = json.loads(line)
                out.append((ev, base64.b64decode(ev["data"]) if "data" in ev else b""))
        return out
    out, off = [], 0
    while off < len(raw):
        (hlen,) = struct.unpack_from("<I", raw, off)
        head = json.loads(raw[off + 4 : off + 4 + hlen].decode())
        off += 4 + hlen
        (plen,) = struct.unpack_from("<I", raw, off)
        out.append((head, raw[off + 4 : off + 4 + plen]))
        off += 4 + plen
    return out


def session_frames(events: list, n: int) -> list:
    """Each session's frames, from frames and frames_batch events."""
    rows = {i: [] for i in range(n)}
    for head, payload in events:
        a = np.frombuffer(payload, dtype="<f4")
        if head.get("event") == "frames":
            rows[head["sid"]].append(a.reshape(head["n"], head["dim"]))
        elif head.get("event") == "frames_batch":
            off = 0
            for m in head["streams"]:
                k = m["n"] * m["dim"]
                rows[m["sid"]].append(a[off : off + k].reshape(m["n"], m["dim"]))
                off += k
    return [np.concatenate(r) if r else np.zeros((0, 0), np.float32) for r in rows.values()]


def round_readings(torch, MultiStreamExtractor, cfg, n: int, tag: str) -> dict:
    """A poll round of n streams at steady state (every stream one block
    and one window): its host wall (median of 20, the sync included), the
    host µs a stream-block, the projected real-time streams (a block's 160
    ms over that), and the device busy time of one round (profiler)."""
    K, S = SERVE_K, cfg.frame_step
    chunk = K * S
    pool = MultiStreamExtractor(cfg, n, frames_per_block=K)
    g = np.random.default_rng(n)
    sids = [pool.open() for _ in range(n)]
    sig = (g.standard_normal((n, 40 * chunk)) * 3000).astype(np.float32)
    pos = [0]

    def step():
        a = pos[0] % sig.shape[1]  # a retraced round wraps to the signal's start
        for i, s in enumerate(sids):
            pool.push(s, sig[i, a : a + chunk])
        pos[0] += chunk
        return pool.poll()

    for _ in range(4):  # primes the windows: the first block needs span = 2,800 samples
        step()
    walls, emitted = [], []
    for _ in range(20):
        for i, s in enumerate(sids):
            pool.push(s, sig[i, pos[0] : pos[0] + chunk])
        pos[0] += chunk
        t0 = time.perf_counter()
        out = pool.poll()
        walls.append((time.perf_counter() - t0) * 1e3)
        emitted.append(sorted({v.shape[0] for v in out.values()}) if len(out) == n else None)
    check(all(e == [K] for e in emitted), f"{n} streams: each timed poll emits {K} frames a stream")
    wall = float(np.median(walls))
    # a trace that lost or doubled a record of the block launch is taken again
    on_device, _ = trace(torch, step, "logmel_kernel", steps=3)
    busy = sum(e.self_device_time_total for e in on_device) / 1e3 / 3
    names = {}
    for e in on_device:
        names[e.name] = names.get(e.name, 0) + 1 / 3
    per_block_us = wall * 1e3 / n
    realtime = K * cfg.hop_s * 1e6 / per_block_us
    print(f"  {n} streams: poll round {wall:.4f} ms wall (median of 20), device busy {busy:.4f} ms "
          f"({busy / wall * 100:.1f}% of the wall), {per_block_us:.2f} us of host a stream-block, "
          f"projected {realtime:.0f} real-time streams {tag}")
    print(f"    device ops a round: " + ", ".join(f"{k[:160]} x{v:g}" for k, v in sorted(names.items())))
    return {"wall_ms": wall, "busy_ms": busy, "per_block_us": per_block_us, "realtime": realtime,
            "ops": names}


def serving_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 23: on-line streaming and serving (see the module docstring)."""
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import MultiStreamExtractor, StreamingExtractor, pad_batch

    t_phase = time.perf_counter()
    cfg = named_config("classic13_deltas")
    K, S, L = SERVE_K, cfg.frame_step, cfg.frame_length
    chunk = int(SERVE_CHUNK_S * cfg.sample_rate)
    print(f"== 23. serving: classic13_deltas, {SERVE_STREAMS} streams of {SERVE_SECONDS[0]:g}-"
          f"{SERVE_SECONDS[1]:g} s pushed in {chunk}-sample chunks, K = {K} {tag}")

    # (b) the block launch against its plain version
    span = (K - 1) * S + L
    g = np.random.default_rng(23)
    edges = [0, 1, L - 1, L, L + 1, span]
    rows = torch.as_tensor((g.standard_normal((2 * len(edges), span + 1)) * 3000).astype(np.float32),
                           device="cuda")
    rows[: len(edges), 0] = 0.0  # t0 = 0: the pre-context is 0; the others' is dirty
    valid = torch.tensor(edges * 2, dtype=torch.int32, device="cuda")
    got = frontend.logmel_block(rows, valid, cfg)
    plain = frontend.logmel_block_reference(rows, valid, cfg)
    errs_b = check_prefix(testing, got, plain, cfg, f"block launch vs plain, valid {edges}, t0 = 0 "
                                                     "and a dirty pre-context")
    t = torch.arange(span + 1, device="cuda")[None, :]
    clean = torch.where(t <= valid[:, None], rows, 0)
    check(torch.equal(got, frontend.logmel_block(clean, valid, cfg)),
          "samples past valid leave the block's prefix unchanged, bitwise")
    for Kb in (16, 128):
        sp = (Kb - 1) * S + L
        r = torch.as_tensor((g.standard_normal((64, sp + 1)) * 3000).astype(np.float32), device="cuda")
        v = torch.full((64,), sp, dtype=torch.int32, device="cuda")
        e = check_prefix(testing, frontend.logmel_block(r, v, cfg), frontend.logmel_block_reference(r, v, cfg),
                         cfg, f"block launch vs plain, 64 rows at K = {Kb}")
        errs_b["max_abs"] = max(errs_b["max_abs"], e["max_abs"])

    # (a) the pool at full width
    xs = stream_signals(cfg, SERVE_STREAMS, *SERVE_SECONDS, seed=230)
    pool = MultiStreamExtractor(cfg, SERVE_STREAMS, frames_per_block=K)
    rounds = counted_rounds(pool, counters)
    t0 = time.perf_counter()
    feats = drive_pool(pool, xs, chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_rounds = check_rounds(rounds, cfg, frontend, f"{SERVE_STREAMS}-stream pool, staggered arrivals")
    check(n_rounds["two_tail_rounds"] > 0, f"{SERVE_STREAMS}-stream pool: first and inner windows "
                                           f"shared a round ({n_rounds['two_tail_rounds']} rounds "
                                           "took two tail launches)")
    audio_s = sum(len(x) for x in xs) / cfg.sample_rate
    print(f"  {SERVE_STREAMS} streams, {audio_s:.1f} audio-s: {len(rounds)} rounds in "
          f"{pool.stats['poll_rounds']} polls, {wall:.3f} s of wall (pushes included) = "
          f"{audio_s / wall:.0f} audio-s/s {tag}")
    check(all(f.shape == (cfg.num_frames(len(x)), cfg.feat_dim) for f, x in zip(feats, xs)),
          "every stream's frame count == the offline count")
    check(all(bool(np.isfinite(f).all()) for f in feats), "finite")
    want = offline_features(torch, chain, pad_batch, cfg, xs)
    err = max(float(np.abs(f - w).max()) for f, w in zip(feats, want))
    print(f"  max |stream - offline extract_batch| over {SERVE_STREAMS} streams: {err:.3e}")
    check(err <= testing.FEATURE_ATOL, f"every stream within {testing.FEATURE_ATOL} of the card's offline "
                                       "extract_batch of the whole utterance")
    b4 = pad_batch([x.astype(np.int16) for x in xs[:4]], cfg, dtype="int16")
    f64, _ = chain.extract_batch(b4.audio, b4.lengths, cfg.replace(dtype="float64"), device="cpu")
    err64 = max(float(np.abs(feats[i] - f64[i, : len(feats[i])].numpy()).max()) for i in range(4))
    print(f"  max |stream - float64 chain| on four streams: {err64:.3e}")
    check(err64 <= testing.FEATURE_ATOL, f"four streams within {testing.FEATURE_ATOL} of the float64 chain")
    counters.zero()
    singles = []
    for x in xs:
        ex = StreamingExtractor(cfg, frames_per_block=K)
        parts = [ex.push(x[a : a + chunk]) for a in range(0, len(x), chunk)]
        singles.append(np.concatenate(parts + [ex.flush()]))
    single_blocks = counters.read()["block"]
    check(all(np.array_equal(a, b) for a, b in zip(feats, singles)),
          f"every stream bitwise its own single-stream StreamingExtractor run ({single_blocks} block "
          "launches there)")
    del singles

    # the profiler's device kernels of one round, at 256 streams
    readings = {n: round_readings(torch, MultiStreamExtractor, cfg, n, tag) for n in SERVE_POOLS}
    ops = readings[SERVE_STREAMS]["ops"]
    kernels = [k for k in ops if "Memcpy" not in k and "Memset" not in k]
    check(sum(v for k, v in ops.items() if "logmel_kernel" in k) == 1
          and sum(v for k, v in ops.items() if "tail_kernel" in k) <= 2,
          f"a {SERVE_STREAMS}-stream round: one front-end block launch, at most two tail launches; "
          f"device kernels a round {dict(sorted((k[:40], round(v, 3)) for k, v in ops.items() if k in kernels))}")

    # (c) every other streamable named config at 16 streams
    for i, name in enumerate(SERVE_CONFIGS):
        c = named_config(name)
        sr = c.input_sample_rate or c.sample_rate
        xs_c = stream_signals(c, SERVE_SMALL, 1.0, 4.0, seed=231 + i)
        raw = offline_features(torch, chain, pad_batch, c, xs_c)
        moments = None
        if c.cmvn == "global":
            allf = np.concatenate(raw).astype(np.float64)
            moments = (allf.sum(0), (allf**2).sum(0), float(allf.shape[0]))
        pool = MultiStreamExtractor(c, SERVE_SMALL, frames_per_block=K, cmvn_moments=moments)
        rounds = counted_rounds(pool, counters)
        got = drive_pool(pool, xs_c, int(SERVE_CHUNK_S * sr))
        check_rounds(rounds, c, frontend, f"{name}, {SERVE_SMALL} streams")
        check(all(f.shape[0] == w.shape[0] for f, w in zip(got, raw)), f"{name}: frame counts == offline")
        if moments is None:
            stream_gate(testing, c, np.concatenate(got), np.concatenate(raw), f"{name} vs offline")
        else:  # the difference before the division by each column's std
            mu = moments[0] / moments[2]
            std = np.sqrt(moments[1] / moments[2] - mu**2 + c.cmvn_eps)
            err = max(float((np.abs(f - (w - mu) / std) * std).max()) for f, w in zip(got, raw))
            print(f"  {name}: max |stream - offline| x std after global CMVN: {err:.3e}")
            check(err <= testing.FEATURE_ATOL, f"{name}: within {testing.FEATURE_ATOL} (in feature units)")

    # (d) single-stream StreamingExtractor at K = 16 and 128 on one 10 s stream
    x = stream_signals(cfg, 1, 10.0, 10.0 + 1e-9, seed=239)[0]
    want1 = offline_features(torch, chain, pad_batch, cfg, [x])[0]
    latency = {}
    for Kb in (16, 128):
        counters.zero()
        ex = StreamingExtractor(cfg, frames_per_block=Kb)
        hop = Kb * S
        walls, evs, parts = [], [], []
        for a in range(0, len(x), hop):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            parts.append(ex.push(x[a : a + hop]))
            end.record()
            walls.append((time.perf_counter() - t0) * 1e3)
            evs.append((start, end))
        parts.append(ex.flush())
        torch.cuda.synchronize()
        got1 = np.concatenate(parts)
        n_blocks = counters.read()["block"]
        check(got1.shape == want1.shape and float(np.abs(got1 - want1).max()) <= testing.FEATURE_ATOL,
              f"StreamingExtractor K = {Kb}: {got1.shape[0]} frames within {testing.FEATURE_ATOL} of "
              f"offline ({n_blocks} block launches)")
        steady = slice(len(walls) // 4, None)  # past the first windows
        lat_wall = float(np.median(walls[steady]))
        lat_ev = float(np.median([s.elapsed_time(e) for s, e in evs[steady]]))
        latency[Kb] = (lat_wall, lat_ev)
        print(f"  single stream, K = {Kb}: a block's push {lat_wall:.4f} ms wall, {lat_ev:.4f} ms by CUDA "
              f"events (median) {tag}")

    # (e) `python -m mfcc_tpu_torch.cli serve` as a subprocess
    xs_s = stream_signals(cfg, SERVE_SESSIONS, 2.0, 4.0, seed=240)
    pool = MultiStreamExtractor(cfg, SERVE_SESSIONS, frames_per_block=K)
    ref = drive_pool(pool, xs_s, chunk)
    base_cmd = [sys.executable, "-m", "mfcc_tpu_torch.cli", "serve", "--config", "classic13_deltas",
                "--streams", str(SERVE_SESSIONS), "--frames-per-block", str(K)]
    for wire, emit in (("jsonl", "b64"), ("binary", "b64-batched")):
        t0 = time.perf_counter()
        res = subprocess.run(base_cmd + ["--wire", wire, "--emit", emit],
                             input=serve_requests(xs_s, chunk, wire), capture_output=True, timeout=300)
        events = serve_events(res.stdout, wire)
        by_sid = session_frames(events, SERVE_SESSIONS)
        frames = [by_sid[k] for k in np.argsort(open_order(SERVE_SESSIONS))]  # back to signal order
        kinds = [h.get("event") for h, _ in events]
        same = all(np.array_equal(a, b) for a, b in zip(frames, ref))
        check(res.returncode == 0 and kinds.count("opened") == SERVE_SESSIONS
              and kinds.count("done") == SERVE_SESSIONS and kinds[-1] == "stats" and same,
              f"serve --wire {wire} --emit {emit}: rc {res.returncode}, {len(events)} events, "
              f"{SERVE_SESSIONS} sessions' frames bitwise the in-process pool's "
              f"({time.perf_counter() - t0:.1f} s) {res.stderr.decode()[-300:] if res.returncode else ''}")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run(base_cmd, input=serve_requests(xs_s[:1], chunk, "jsonl"), env=env,
                         capture_output=True, timeout=120)
    check(res.returncode == 2 and not res.stdout.strip(),
          f"with CUDA_VISIBLE_DEVICES='' serve exits {res.returncode} and prints no event")

    # (f) the readings
    print(f"  readings {tag}:")
    for n, r in readings.items():
        print(f"    {n} streams: round {r['wall_ms']:.4f} ms wall, {r['busy_ms']:.4f} ms device busy, "
              f"{r['per_block_us']:.2f} us a stream-block, {r['realtime']:.0f} real-time streams")
    for Kb, (w, e) in latency.items():
        print(f"    single stream K = {Kb}: {w:.4f} ms wall, {e:.4f} ms by events a block")
    results["frontend"].update(block_launches=n_rounds["blocks"],
                               block_launches_per_round=n_rounds["block_max"],
                               block_max_abs_err=errs_b["max_abs"])
    results["feature_tail"].update(serve_launches=n_rounds["tails"],
                                   serve_launches_per_round=n_rounds["tail_max"],
                                   serve_rounds_with_two=n_rounds["two_tail_rounds"])
    print(f"  phase 23 took {time.perf_counter() - t_phase:.1f} s")


TRAIN_GATE = 1e-3  # the gradient's relative max diff from the float64 plain chain's (tests/test_grad.py:104)
TRAIN_SMALL_B, TRAIN_SMALL_S = 4, 1  # the named configs' depth on the training path


def grad_rel(torch, chain, cfg, audio, lengths, grad) -> float:
    """max |grad - the float64 plain chain's gradient| / its max |.|, of
    (feat**2).sum() at audio (float32 rows on the card)."""
    a64 = audio.double().requires_grad_(True)
    f64, _ = chain.plain_chain(a64, lengths, cfg.replace(dtype="float64"))
    (f64**2).sum().backward()
    return float((grad.double() - a64.grad).abs().max() / a64.grad.abs().max())


def training_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 24: the training path, `chain.extract_batch_diff` (see the
    module docstring)."""
    from mfcc_tpu_torch import named_config
    from mfcc_tpu_torch.config import NAMED_CONFIGS
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    cfg = named_config("classic13_deltas")
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 571, seed=0)
    audio = torch.as_tensor(batch.audio, dtype=torch.float32, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    print(f"== 24. the training path: chain.extract_batch_diff, classic13_deltas b{B} x {SECONDS} s float32 "
          f"[{B}, {audio.shape[1]}], loss (feat**2).sum()")
    a = audio.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters.zero()
    feat, mask = chain.extract_batch_diff(a, lengths, cfg)
    (feat**2).sum().backward()
    torch.cuda.synchronize()
    launches = counters.expect("a training step (forward and backward)", frontend=1, tail=1)
    peak = torch.cuda.max_memory_allocated()
    want, want_mask = chain.extract_batch(audio, lengths, cfg)
    check(torch.equal(feat.detach(), want) and torch.equal(mask, want_mask) and not mask.requires_grad,
          "the forward is extract_batch's, bitwise; the mask has no gradient")
    check(bool(torch.isfinite(a.grad).all()) and bool(a.grad.any()), "the gradient is finite and not 0")
    rel = grad_rel(torch, chain, cfg, audio, lengths, a.grad)
    print(f"  gradient vs the float64 plain chain's on the card: relative max diff {rel:.3e}")
    check(rel < TRAIN_GATE, f"within {TRAIN_GATE}")
    a.grad = None
    feat, _ = chain.extract_batch_diff(a, lengths, cfg)
    (feat[0] ** 2).sum().backward()
    n0 = int(batch.lengths[0])
    check(not a.grad[1:].any() and not a.grad[0, n0:].any() and bool(a.grad[0, :n0].any()),
          "a row-0 loss: exactly 0 gradient on rows 1-63 and past row 0's length")

    steps = []
    for _ in range(12):
        a.grad = None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = (chain.extract_batch_diff(a, lengths, cfg)[0] ** 2).sum()
        ev[1].record()
        loss.backward()
        ev[2].record()
        torch.cuda.synchronize()
        steps.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    fwd_ms, bwd_ms = (float(np.median([s[i] for s in steps[2:]])) for i in (0, 1))
    # the backward alone under the profiler: graphs made first, one a call
    losses = [(chain.extract_batch_diff(a, lengths, cfg)[0] ** 2).sum() for _ in range(7)]
    on_device, _ = trace(torch, lambda: losses.pop().backward(), None, steps=5)
    bwd_ops = len(on_device) / 5
    bwd_busy = sum(e.self_device_time_total for e in on_device) / 1e3 / 5
    audio_s = float(batch.lengths.sum()) / cfg.sample_rate  # the rows' valid samples, not their padding
    print(f"  forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms by CUDA events (median of 10 steps); a training "
          f"step {fwd_ms + bwd_ms:.4f} ms = {audio_s / ((fwd_ms + bwd_ms) / 1e3):.0f} audio-s/s "
          f"({audio_s:.2f} audio-s a step) {tag}")
    print(f"  the backward (the plain chain's VJP): {bwd_ops:.0f} device kernels and copies, device busy "
          f"{bwd_busy:.4f} ms ({bwd_busy / bwd_ms * 100:.1f}% of its {bwd_ms:.4f} ms) {tag}")
    print(f"  peak device memory of a training step: {peak / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    results["frontend"]["train_launches"] = launches["frontend"]
    results["feature_tail"]["train_launches"] = launches["tail"]
    del a, audio, feat, losses

    # every named config at b4 x 1 s, and kaldi_mfcc with dither (the contract
    # noise in the kernel's forward and in the plain chain's backward)
    g = np.random.default_rng(24)
    dithered = named_config("kaldi_mfcc").replace(dither=1.0)
    for name, cfg in [*NAMED_CONFIGS.items(), ("kaldi_mfcc dither 1.0", dithered)]:
        sr = cfg.input_sample_rate or cfg.sample_rate
        xs = [g.standard_normal(TRAIN_SMALL_S * sr - 571 * i * sr // 16000) * 3000 for i in range(TRAIN_SMALL_B)]
        b = pad_batch(xs, cfg)
        x = torch.as_tensor(b.audio, dtype=torch.float32, device="cuda")
        n_d = torch.as_tensor(b.lengths, device="cuda")
        a = x.clone().requires_grad_(True)
        counters.zero()
        feat, mask = chain.extract_batch_diff(a, n_d, cfg)
        (feat**2).sum().backward()
        torch.cuda.synchronize()
        counts = {k: v for k, v in counters.read().items() if v}
        want, _ = chain.extract_batch(x, n_d, cfg)
        rel = grad_rel(torch, chain, cfg, x, n_d, a.grad)
        print(f"  {name} b{TRAIN_SMALL_B} x {TRAIN_SMALL_S} s: launches {counts}; gradient vs float64 {rel:.3e}")
        check(torch.equal(feat.detach(), want) and bool(torch.isfinite(a.grad).all()) and rel < TRAIN_GATE,
              f"{name}: the forward bitwise extract_batch's, the gradient finite and within {TRAIN_GATE}")
        check(counts.get("frontend", 0) + counts.get("fused", 0) == 1 and "resample" not in counts
              and counts.get("dither", 0) == (cfg.dither > 0),
              f"{name}: one front-end launch (the dither branch when dithering), no polyphase kernel")
    print(f"  phase 24 took {time.perf_counter() - t_phase:.1f} s")


def tools_path(torch, tag: str, tmp) -> None:
    """Phase 25: `cli convert`, `cli info --self-test` and `stage_times`
    (see the module docstring)."""
    import contextlib
    import io

    from mfcc_tpu_torch import cli, named_config
    from mfcc_tpu_torch.io import ShardWriter, read_shard
    from mfcc_tpu_torch.io.writer import iter_feature_shards
    from mfcc_tpu_torch.pipeline import pad_batch
    from mfcc_tpu_torch.utils.trace import stage_times

    t_phase = time.perf_counter()
    print("== 25. the tools: cli convert, cli info --self-test, utils.trace.stage_times")
    cfg = named_config("classic13_deltas")
    src = tmp / "a"
    for fmt in ("htk", "kaldi"):
        out, ref = tmp / f"convert_{fmt}", tmp / f"writer_{fmt}"
        check(cli.main(["convert", str(src), "-o", str(out), "--to", fmt, "--config", "classic13_deltas"]) == 0,
              f"convert --to {fmt}: exit 0")
        w = ShardWriter(ref, cfg, fmt=fmt)  # io/htk.py, io/kaldi.py on the same features
        for p in iter_feature_shards(src):
            feats = read_shard(p)
            w.write(p.stem, list(feats), list(feats.values()))

        def files(d):
            return {q.relative_to(d).as_posix(): q.read_bytes().replace(str(d).encode(), b"")
                    for q in d.rglob("*") if q.is_file() and q.parent.name != "done"}

        got, want = files(out), files(ref)
        check(got == want and len(got) > 0, f"convert --to {fmt}: {len(got)} files, the bytes of io/{fmt}.py "
                                             "writing the same features")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["info", "--self-test"])
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith(("torch", "card", "process", "self-test")):
            print(f"  info: {line}")
    check(rc == 0 and lines[-1] == "self-test: PASS", "info --self-test on the card: PASS")
    batch = make_batch(pad_batch, cfg, B, cfg.sample_rate * SECONDS, 571, seed=0)
    st = stage_times(torch.as_tensor(batch.audio, device="cuda"), torch.as_tensor(batch.lengths, device="cuda"),
                     cfg)
    print("  stage_times, classic13_deltas b64 x 10 s int16 on the card (CUDA events, best of 3): "
          + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in st.items()) + f" {tag}")
    check(set(st) == {"preemph", "logmel", "full", "features_minus_logmel"} and min(st.values()) >= 0,
          "stage_times: four non-negative keys")
    print("  plot: not driven here (`cli plot` needs matplotlib, which this machine lacks: it exits 2 and "
          "names the package; tests/test_torch_tools.py draws its PNGs on the CPU)")
    print(f"  phase 25 took {time.perf_counter() - t_phase:.1f} s")

RS48_SECONDS = 30  # whisper80 fed 48 kHz: Whisper's padded chunk


def conv1d_resample(torch, x, d):
    """The library's yardstick of a resample at up = 1 (polyphase_design
    d): a call of conv1d over the rows x [B, T] zero-padded by half_len,
    with the reversed taps, at stride down (its inputs made once)."""
    taps = torch.as_tensor(np.ascontiguousarray(d["table"][0, ::-1]), dtype=torch.float32,
                           device=x.device)[None, None]
    xpad = torch.nn.functional.pad(x, (d["half_len"], d["half_len"]))[:, None]
    return lambda: torch.nn.functional.conv1d(xpad, taps, stride=d["down"])
RESAMPLED_FAMILIES = ("kaldi_plp", "kaldi_spectrogram", "ssc26")


def resampled_rows_path(torch, counters, tag: str, results: dict) -> None:
    """Phase 26: resampled rows take every framing, DFT route and ratio: the
    split route (resample.cu on the rows, zeroed past each length, then the
    plain form) for centered framing and for fused layouts over the block,
    bf16x3 in the fused form, and resample.cu at a reduced tile and with
    its taps read from device memory."""
    import types

    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import frontend
    from mfcc_tpu_torch.kernels import resample as rs_kernel
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.ops import resample as R
    from mfcc_tpu_torch.pipeline import pad_batch

    t_phase = time.perf_counter()
    # 26.1 whisper80 fed 48 kHz at full width
    cfg = named_config("whisper80").replace(input_sample_rate=48000)
    sr_in = cfg.input_sample_rate
    n = sr_in * RS48_SECONDS
    pcm = (np.random.default_rng(26).standard_normal((B, n)) * 3000).astype(np.int16)
    lens = np.full(B, n, np.int32)
    n16 = R.output_length(n, sr_in, cfg.sample_rate)
    F, M = cfg.num_frames(n16), cfg.n_mels
    audio = torch.as_tensor(pcm, device="cuda")
    lengths = torch.as_tensor(lens, device="cuda")
    print(f"== 26. resampled rows: the split route, bf16x3 fused, resample.cu's plans")
    print(f"  26.1 whisper80 fed 48 kHz, b{B} x {RS48_SECONDS} s int16 [{B}, {n}] -> {n16} samples at "
          f"16 kHz, {F} frames; route {frontend.resample_route(cfg)} (resample.cu plan "
          f"{rs_kernel.plan(*R.ratio(sr_in, cfg.sample_rate))}, then the plain form's centered staging)")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the split route", resample=1, frontend=1, centered=1, split=1)
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    errs = check_prefix64(testing, frontend, got, audio, lengths, cfg, "whisper80 fed 48 kHz")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    del got
    check_counts(torch, frontend, audio, lengths, cfg, "whisper80 fed 48 kHz")
    counters.zero()
    feat, mask = chain.extract_batch(pcm, lens, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("extract_batch", resample=1, frontend=1, centered=1, split=1)
    check(tuple(feat.shape) == (B, F, M) and bool(torch.isfinite(feat).all()),
          f"features {tuple(feat.shape)}, finite")
    cpu_feat, cpu_mask = chain.extract_batch(pcm, lens, cfg, device="cpu")
    check(torch.equal(mask.cpu(), cpu_mask), "frame mask equal to the CPU chain's")
    whisper_gate(testing, feat, cpu_feat, testing.WHISPER_ATOL, "CPU chain")
    del cpu_feat
    f64, _ = chain.extract_batch(pcm[:4], lens[:4], cfg.replace(dtype="float64"), device="cpu")
    whisper_gate(testing, feat[:4], f64, testing.WHISPER_ORACLE_ATOL, "float64 chain (rows 0-3)")
    del feat, mask, f64
    lengths32 = lengths.to(torch.int32)
    zeros16 = torch.zeros((B, n16), dtype=torch.int16, device="cuda")
    full16 = torch.full((B,), n16, dtype=torch.int32, device="cuda")
    _, norm16 = step_kernels(torch, lambda: chain.extract_batch(zeros16, full16, named_config("whisper80")),
                             kernel_substr="logmel_kernel")
    _, names = step_kernels(torch, lambda: chain.extract_batch(audio, lengths32, cfg),
                            kernel_substr="logmel_kernel")
    print("  one extract_batch step: " + ", ".join(f"{k[:60]} x{v:g}" for k, v in sorted(names.items())))
    norm = {k: v for k, v in norm16.items() if "logmel_kernel" not in k}
    rest = {k: v for k, v in names.items() if "logmel_kernel" not in k and "resample_kernel" not in k}
    check(sum(v for k, v in names.items() if "resample_kernel" in k) == 1
          and sum(v for k, v in names.items() if "logmel_kernel" in k) == 1 and rest == norm,
          f"the step runs resample.cu once, the front-end once and the whisper norm's {sum(norm.values()):g} "
          "torch kernels (those of a 16 kHz whisper80 step at the same shape), nothing else")
    del zeros16
    print(f"  times {tag}")
    route_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    rs_ms = device_ms(torch, lambda: rs_kernel.resample_rows(audio, lengths32, sr_in, cfg.sample_rate))
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=5)
    d = R.polyphase_design(*R.ratio(sr_in, cfg.sample_rate))
    conv_ms = cuda_ms(torch, conv1d_resample(torch, audio.float(), d))
    st = chain.logmel_stages(*chain.resample_input(audio[:16], lengths[:16], cfg), cfg)
    framed = st["windowed"].reshape(-1, cfg.frame_length).repeat(B // 16, 1).contiguous()
    del st
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, n=cfg.n_fft, dim=-1))
    del framed
    lens16 = np.array([R.output_length(int(x), sr_in, cfg.sample_rate) for x in lens])
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, B, F, taps=d["up"] * d["K"]),
                               frontend_ops(cfg, chain, frontend, torch, lens16, F)
                               + resample_ops(R, d["up"], d["down"], lens16, cfg, F))
    print(f"  the split route (resample.cu, then the plain form): {route_ms:.4f} ms "
          f"({bound_ms / route_ms * 100:.1f}% of bound); resample.cu alone {rs_ms:.4f} ms device time {tag}")
    print(f"  plain version (float64 two-dot resample, gather + rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  library, resample and DFT only: conv1d stride {d['down']} {conv_ms:.4f} ms + "
          f"torch.fft.rfft(n={cfg.n_fft}) on [{B * F}, {cfg.frame_length}] {rfft_ms:.4f} ms = "
          f"{conv_ms + rfft_ms:.4f} ms {tag}")
    step_times(torch, chain, types.SimpleNamespace(audio=pcm, lengths=lens), audio, lengths, cfg,
               "front-end kernel", tag, seconds=RS48_SECONDS)
    results["centered_resampled"] = dict(
        launches=launches["split"], max_abs_err=errs["max_abs"], ms=route_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=conv_ms + rfft_ms)
    del audio, lengths, lengths32

    # 26.2 classic13_deltas centered at 44.1 kHz: three device kernels a step
    cfg = named_config("classic13_deltas").replace(frame_tail="center", input_sample_rate=44100)
    batch = make_batch(pad_batch, cfg, B, 44100 * SECONDS, 1573, seed=27)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda").to(torch.int32)
    print(f"  26.2 classic13_deltas centered at 44.1 kHz, b{B} x {SECONDS} s int16 {list(audio.shape)}")
    check_prefix(testing, frontend.logmel_prefix(audio, lengths, cfg),
                 frontend.logmel_prefix_reference(audio, lengths, cfg), cfg, "kernel route vs plain")
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("extract_batch", resample=1, frontend=1, centered=1, split=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.RESAMPLED_FEATURE_ATOL)
    del feat, mask
    per_step, names = step_kernels(torch, lambda: chain.extract_batch(audio, lengths, cfg))
    print(f"  one step: {per_step:.0f} device kernels: "
          + ", ".join(f"{k[:60]} x{v:g}" for k, v in sorted(names.items())))
    kinds = ("resample_kernel", "logmel_kernel", "tail_kernel")
    check(per_step == 3 and all(sum(v for k, v in names.items() if s in k) == 1 for s in kinds),
          "exactly three device kernels a step: resample, front-end and tail")
    e_ms = cuda_ms(torch, lambda: chain.extract_batch(audio, lengths, cfg), reps=10)
    print(f"  extract_batch step {e_ms:.4f} ms = {B * SECONDS / (e_ms / 1e3):.0f} audio-s/s {tag}")
    del audio, lengths

    # 26.3 kaldi_mfcc centered with dither at 48 kHz
    cfg = named_config("kaldi_mfcc").replace(frame_tail="center", dither=1.0, input_sample_rate=48000)
    batch = make_batch(pad_batch, cfg, B_SMALL, 48000 * SECONDS, 1713, seed=28)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda").to(torch.int32)
    print(f"  26.3 kaldi_mfcc centered, dither 1.0, at 48 kHz, b{B_SMALL} x {SECONDS} s int16 "
          f"{list(audio.shape)}")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the split route", resample=1, frontend=1, centered=1, split=1, dither=1,
                    conditioning=1)
    check_prefix(testing, got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg,
                 "dither and conditioning after the resample vs plain")
    check(torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg))
          and torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "two runs, and int16 and float32 rows, bitwise equal")
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("extract_batch", resample=1, frontend=1, centered=1, split=1, dither=1,
                    conditioning=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.RESAMPLED_FEATURE_ATOL)
    del audio, lengths, got, feat, mask

    # 26.4 the families centered at 48 kHz
    for name in RESAMPLED_FAMILIES:
        cfg = named_config(name).replace(frame_tail="center", input_sample_rate=48000)
        kind = frontend.feature_kind(cfg)
        batch = make_batch(pad_batch, cfg, B_SMALL, 48000 * SECONDS, 1713, seed=29)
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda").to(torch.int32)
        print(f"  26.4 {name} centered at 48 kHz, b{B_SMALL} x {SECONDS} s int16 {list(audio.shape)}")
        check_prefix(testing, frontend.logmel_prefix(audio, lengths, cfg),
                     frontend.logmel_prefix_reference(audio, lengths, cfg), cfg, f"{kind} kind vs plain")
        counters.zero()
        feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
        torch.cuda.synchronize()
        counters.expect("extract_batch", resample=1, frontend=1, centered=1, split=1, **{kind: 1},
                        **({"conditioning": 1} if chain.needs_conditioning(cfg) else {}))
        check_features(torch, chain, testing, batch, cfg, feat, mask, None)
        del audio, lengths, feat, mask

    # 26.5 bf16x3 in the fused form
    for name, step, seed in (("mfcc39_48k", 1713, 30), ("mfcc39_44k", 1573, 31)):
        cfg = named_config(name)
        sr_in = cfg.input_sample_rate
        batch = make_batch(pad_batch, cfg, B, sr_in * SECONDS, step, seed=seed)
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda").to(torch.int32)
        T = audio.shape[1]
        F = cfg.num_frames(R.output_length(T, sr_in, cfg.sample_rate))
        route = frontend.resample_route(cfg, "bf16x3")
        print(f"  26.5 bf16x3 on {name}, b{B} x {SECONDS} s int16 {list(audio.shape)}: route {route}, "
              f"plan int16 {frontend.bf16_plan(cfg, True)}, float32 {frontend.bf16_plan(cfg, False)} "
              f"(frames a block, ring stages)")
        check(route == "fused", "the fused form takes bf16x3")
        for int16 in (True, False):
            info = frontend.kernel_info(cfg, int16, "bf16x3")
            print(f"    {'int16' if int16 else 'float32'} rows: {info['registers']} registers, "
                  f"{info['local_bytes']} local bytes, {info['blocks_per_sm']} blocks an SM at "
                  f"{info['smem_bytes']} B")
            check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, "no spills, resident")
        counters.zero()
        got = frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3")
        torch.cuda.synchronize()
        launches = counters.expect("logmel_prefix(dft_passes='bf16x3')", fused=1, bf16x3=1)
        plain = frontend.logmel_prefix_reference(audio, lengths, cfg, dft_passes="bf16x3")
        e = testing.prefix_errors(got, plain, cfg.n_mels)
        print("  kernel vs its plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in e.items()))
        fails = testing.prefix_failures(e, testing.BF16X3_LOUD_ATOL)
        check(not fails, f"within the bf16x3 gates of the plain version {fails or ''}")
        del plain
        check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg, dft_passes="bf16x3")),
              "int16 rows == the same rows in float32, bitwise")
        del got
        check_counts(torch, frontend, audio, lengths, cfg, f"bf16x3 {name}", "bf16x3")
        k_ms, r_ms = in_turns(torch, [
            lambda: frontend.logmel_prefix(audio, lengths, cfg, dft_passes="bf16x3"),
            lambda: frontend.logmel_prefix(audio, lengths, cfg)])
        print(f"  bf16x3 fused kernel {k_ms:.4f} ms; the radix-4 (Stockham) fused kernel {r_ms:.4f} ms, "
              f"in turns {tag}")
        if name == "mfcc39_48k":
            plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(
                audio, lengths, cfg, dft_passes="bf16x3"), reps=5)
            lens_in = np.minimum(batch.lengths.astype(np.int64), T)
            lens16 = np.array([R.output_length(int(x), sr_in, cfg.sample_rate) for x in lens_in])
            d = R.polyphase_design(*R.ratio(sr_in, cfg.sample_rate))
            kp, nbp = frontend.bf16_dims(cfg)
            bound_ms, bound_by = bound(
                frontend_bytes(cfg, frontend, lens_in, B, F, taps=d["up"] * d["K"]) + 2 * kp * 2 * nbp * 2,
                frontend_ops(cfg, chain, frontend, torch, lens16, F)
                + resample_ops(R, d["up"], d["down"], lens16, cfg, F))
            print(f"  its three bf16 passes alone: {3 * 2 * kp * 2 * nbp * B * F / PEAK_BF16_FLOPS * 1e3:.4f} ms "
                  f"at the bf16 peak")
            conv_ms = cuda_ms(torch, conv1d_resample(torch, audio.float(), d))
            st = chain.logmel_stages(*chain.resample_input(audio, lengths, cfg), cfg)
            framed = torch.nn.functional.pad(st["windowed"].reshape(B * F, -1),
                                             (0, cfg.n_fft - cfg.frame_length)).contiguous()
            del st
            rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
            del framed
            print(f"  plain version {plain_ms:.4f} ms; library conv1d + rfft {conv_ms + rfft_ms:.4f} ms {tag}")
            results["bf16x3_fused"] = dict(
                launches=launches["bf16x3"], max_abs_err=e["max_abs"], ms=k_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=conv_ms + rfft_ms)
        del audio, lengths

    # 26.6 classic13_deltas at 192 kHz: the split route
    cfg = named_config("classic13_deltas").replace(input_sample_rate=192000)
    batch = make_batch(pad_batch, cfg, B_SMALL, 192000 * SECONDS, 6852, seed=32)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda").to(torch.int32)
    print(f"  26.6 classic13_deltas at 192 kHz, b{B_SMALL} x {SECONDS} s int16 {list(audio.shape)}: "
          f"route {frontend.resample_route(cfg)} (the fused layout {frontend.smem_bytes(cfg, int16=False):,} B "
          f"with float32 rows), resample.cu plan {rs_kernel.plan(*R.ratio(192000, 16000))}")
    check(frontend.resample_route(cfg) == "split", "the split route, by the layout mirror")
    check_prefix(testing, frontend.logmel_prefix(audio, lengths, cfg),
                 frontend.logmel_prefix_reference(audio, lengths, cfg), cfg, "kernel route vs plain")
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("extract_batch", resample=1, frontend=1, split=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.RESAMPLED_FEATURE_ATOL)
    e_ms = cuda_ms(torch, lambda: chain.extract_batch(audio, lengths, cfg), reps=10)
    print(f"  extract_batch step {e_ms:.4f} ms = {B_SMALL * SECONDS / (e_ms / 1e3):.0f} audio-s/s {tag}")
    del audio, lengths, feat, mask

    # 26.7 resample_batch at a reduced tile and with global taps
    for key, sr_in, sr_out, counts in (
        ("resample_reduced_tile", 192000, 8000, {"reduced_tile": 1}),
        ("resample_global_taps", 16000, 15999, {"global_taps": 1}),
    ):
        up, down = R.ratio(sr_in, sr_out)
        d = R.polyphase_design(up, down)
        T = sr_in * SECONDS
        x = torch.as_tensor((np.random.default_rng(sr_out).standard_normal((4, T)) * 3000).astype(np.float32),
                            device="cuda")
        n_out = R.output_length(T, sr_in, sr_out)
        info = rs_kernel.kernel_info(sr_in, sr_out)
        print(f"  26.7 resample_batch {sr_in} -> {sr_out} Hz (up {up}, down {down}, {d['K']} taps a "
              f"phase) on [4, {T}]: tile {info['tile']} outputs, taps {info['mode']}; "
              f"{info['registers']} registers, {info['local_bytes']} local bytes, "
              f"{info['blocks_per_sm']} blocks an SM at {info['smem_bytes']} B")
        counters.zero()
        y = R.resample_batch(x, sr_in, sr_out)
        torch.cuda.synchronize()
        launches = counters.expect("resample_batch", resample=1, **counts)
        plain = rs_kernel.resample_reference(x, sr_in, sr_out)
        err = testing.resample_error(y, plain, x)
        max_abs_err = float((y - plain).abs().max())
        del plain
        want = np.stack([R.resample_numpy(r, sr_in, sr_out) for r in x.double().cpu().numpy()])
        sp_err = testing.resample_error(y, want, x)
        print(f"  kernel vs plain {err:.3e}, vs scipy float64 {sp_err:.3e} (of each row's max |x|)")
        check(tuple(y.shape) == (4, n_out) and err < testing.RESAMPLE_KERNEL_REL_ROWMAX
              and sp_err < testing.RESAMPLE_KERNEL_REL_ROWMAX,
              f"within {testing.RESAMPLE_KERNEL_REL_ROWMAX} of the plain version and of scipy")
        k_ms = device_ms(torch, lambda: R.resample_batch(x, sr_in, sr_out))
        plain_ms = cuda_ms(torch, lambda: rs_kernel.resample_reference(x, sr_in, sr_out), reps=5)
        library_ms = cuda_ms(torch, conv1d_resample(torch, x, d)) if up == 1 else None
        bound_ms, bound_by = bound(4 * T * 4 + 4 * n_out * 4 + d["up"] * d["K"] * 4,
                                   resample_ops(R, up, down, [n_out] * 4))
        lib = "none (no single PyTorch call computes a 15999/16000 resample)" if library_ms is None \
            else f"conv1d stride {down} {library_ms:.4f} ms"
        print(f"  resample.cu {k_ms:.4f} ms device time ({bound_ms / k_ms * 100:.1f}% of bound); plain "
              f"{plain_ms:.4f} ms; library {lib} {tag}")
        results[key] = dict(launches=launches["resample"], max_abs_err=max_abs_err, ms=k_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        del x, y
    print(f"  phase 26 took {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    args.add_argument("--seed", type=int, default=0, help="seed of the corpus phase's wav files")
    args = args.parse_args(argv)
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from mfcc_tpu_torch import named_config, testing
    from mfcc_tpu_torch.kernels import _build, frontend, tail
    from mfcc_tpu_torch.kernels import resample as rs_kernel
    from mfcc_tpu_torch.ops import chain
    from mfcc_tpu_torch.ops import resample as R
    from mfcc_tpu_torch.pipeline import pad_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = Counters(frontend, rs_kernel, tail)
    results = {}

    # 1. the card
    print("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", "nvidia-smi reads the card")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); device 0: {kind}; "
          f"{torch.cuda.device_count()} device(s)")
    tag = f"[{card}]"

    # 2. build every kernel source, in parallel, with the breakdown's cuts
    print("== 2. build")
    breakdown = load_breakdown()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        cut_builds = pool.submit(breakdown.build_cuts, _build.CSRC, _build.BUILD_DIR / "breakdown")
        builds = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
        cut_builds = cut_builds.result()
    print(f"built {', '.join(p.name for p, _ in builds.values())} and the front-end's three "
          f"breakdown cuts in {time.perf_counter() - t0:.1f} s: nvcc {' '.join(_build.NVCC_FLAGS)}")
    for _, log in builds.values():
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"    {line.strip()}")
    occupancy(frontend, named_config)

    # 3. classic13_deltas: the front-end kernel
    cfg = named_config("classic13_deltas")
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 571, seed=0)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")

    print(f"== 3. path classic13_deltas b{B} x {SECONDS} s int16 [{B}, {T}]")
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs = check_prefix(testing, got, plain, cfg, "main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 1), lengths, cfg)),
          "garbage past each length leaves the output unchanged (main batch)")
    t = torch.arange(T, device="cuda")[None, :]
    bl = torch.tensor(BOUNDARY_LENGTHS, dtype=torch.int32, device="cuda")
    b_dirty = audio[: len(BOUNDARY_LENGTHS), :16000].contiguous()
    b_clean = torch.where(t[:, :16000] < bl[:, None], b_dirty, 0)
    b_got = frontend.logmel_prefix(b_dirty, bl, cfg)
    check(torch.equal(b_got, frontend.logmel_prefix(b_clean, bl, cfg)),
          f"boundary lengths {BOUNDARY_LENGTHS}: dirty tails == clean")
    check_prefix(testing, b_got, frontend.logmel_prefix_reference(b_clean, bl, cfg), cfg,
                 "boundary lengths")
    eps = torch.tensor(cfg.log_eps, dtype=torch.float32)
    check(bool((b_got[0, :, M] == eps.cuda()).all())
          and bool(torch.allclose(b_got[0, :, :M].cpu(), torch.log(eps), rtol=1e-6)),
          "length-0 row is the clamp constant")

    check_counts(torch, frontend, audio, lengths, cfg, "classic13_deltas")

    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.FEATURE_ATOL)
    results["feature_tail"] = main_path_tail(torch, chain, testing, tail, cfg, got, lengths, feat,
                                             mask, launches, tag)
    lengths32 = lengths.to(torch.int32)
    per_step, names = step_kernels(torch, lambda: chain.extract_batch(audio, lengths32, cfg))
    print(f"  one extract_batch step (int16 rows, int32 lengths on the card): {per_step:.0f} device "
          f"kernels: " + ", ".join(f"{k[:60]} x{v:g}" for k, v in sorted(names.items())))
    others = [k for k in names if "logmel_kernel" not in k and "tail_kernel" not in k]
    check(not others and any("logmel_kernel" in k for k in names) and all(v <= 1 for v in names.values()),
          "the classic13_deltas step runs the front-end and the tail kernel and no other device kernel")

    print(f"  times {tag}")
    kernel_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=10)
    st = chain.logmel_stages(audio, lengths, cfg)
    framed = torch.nn.functional.pad(st["windowed"].reshape(B * F, -1), (0, cfg.n_fft - cfg.frame_length))
    framed = framed.contiguous()
    del st
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
    lens = np.minimum(batch.lengths.astype(np.int64), T)
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, B, F),
                               frontend_ops(cfg, chain, frontend, torch, lens, F))
    print(f"  frontend kernel: {kernel_ms:.4f} ms ({bound_ms / kernel_ms * 100:.1f}% of bound) {tag}")
    print(f"  plain version (torch rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  torch.fft.rfft on [{B * F}, {cfg.n_fft}] pre-framed (DFT only): {rfft_ms:.4f} ms {tag}")
    step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag)
    results["frontend"] = dict(
        launches=launches["frontend"], max_abs_err=errs["max_abs"], ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=rfft_ms,
    )
    del audio, lengths, framed, feat, mask

    # 4. mfcc39_48k: the fused resample
    cfg = named_config("mfcc39_48k")
    sr_in = cfg.input_sample_rate
    n = sr_in * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 1713, seed=2)
    T = batch.audio.shape[1]
    T16 = R.output_length(T, sr_in, cfg.sample_rate)
    F, M = cfg.num_frames(T16), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")

    print(f"== 4. path mfcc39_48k b{B} x {SECONDS} s int16 [{B}, {T}] -> {T16} samples at 16 kHz")
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs = check_prefix(testing, got, plain, cfg, "main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 3), lengths, cfg)),
          "garbage past each input length leaves the output unchanged (main batch)")
    t = torch.arange(T, device="cuda")[None, :]
    bl = torch.tensor(RS_BOUNDARY_LENGTHS, dtype=torch.int32, device="cuda")
    b_dirty = audio[: len(RS_BOUNDARY_LENGTHS), :48000].contiguous()
    b_clean = torch.where(t[:, :48000] < bl[:, None], b_dirty, 0)
    b_got = frontend.logmel_prefix(b_dirty, bl, cfg)
    check(torch.equal(b_got, frontend.logmel_prefix(b_clean, bl, cfg)),
          f"boundary input lengths {RS_BOUNDARY_LENGTHS}: dirty tails == clean")
    check_prefix(testing, b_got, frontend.logmel_prefix_reference(b_clean, bl, cfg), cfg,
                 "boundary input lengths")
    del plain
    check_counts(torch, frontend, audio, lengths, cfg, "mfcc39_48k")
    check_counts(torch, frontend, b_dirty, bl, cfg, "mfcc39_48k")

    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", fused=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.RESAMPLED_FEATURE_ATOL)
    del feat, mask

    print(f"  times {tag}")
    for int16 in (True, False):
        info = frontend.kernel_info(cfg, int16)
        print(f"  fused instantiation, {'int16' if int16 else 'float32'} rows: {info['registers']} registers, "
              f"{info['local_bytes']} local bytes, {info['blocks_per_sm']} blocks an SM at "
              f"{info['smem_bytes']} B")
    kernel_ms, split_ms = fused_and_split(torch, frontend, R, cfg, audio, lengths)
    plain_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=10)
    d = R.polyphase_design(*R.ratio(sr_in, cfg.sample_rate))
    taps = torch.as_tensor(np.ascontiguousarray(d["table"][0, ::-1]), dtype=torch.float32,
                           device="cuda")[None, None]
    xpad = torch.nn.functional.pad(audio.float(), (d["half_len"], d["half_len"]))[:, None]
    conv = torch.nn.functional.conv1d(xpad, taps, stride=d["down"])[:, 0]
    ref16 = R.resample_reference(audio.float(), sr_in, cfg.sample_rate)
    print(f"  conv1d yardstick vs the plain resample: max |diff| {float((conv - ref16).abs().max()):.3e} "
          f"(of max |x| {float(audio.abs().max()):.0f})")
    conv_ms = cuda_ms(torch, lambda: torch.nn.functional.conv1d(xpad, taps, stride=d["down"]))
    st = chain.logmel_stages(ref16, R.output_lengths(lengths, sr_in, cfg.sample_rate), cfg)
    framed = torch.nn.functional.pad(st["windowed"].reshape(B * F, -1), (0, cfg.n_fft - cfg.frame_length))
    framed = framed.contiguous()
    del st, conv, ref16
    rfft_ms = cuda_ms(torch, lambda: torch.fft.rfft(framed, dim=-1))
    lens_in = np.minimum(batch.lengths.astype(np.int64), T)
    lens16 = np.array([R.output_length(int(x), sr_in, cfg.sample_rate) for x in lens_in])
    fe_ops = frontend_ops(cfg, chain, frontend, torch, lens16, F)
    rs_ops = resample_ops(R, *R.ratio(sr_in, cfg.sample_rate), lens16, cfg, F)
    print(f"  resample: {int(lens16.sum())} output samples with signal, {rs_ops / lens16.sum():.0f} FLOP each")
    bound_ms, bound_by = bound(
        frontend_bytes(cfg, frontend, lens_in, B, F, taps=d["up"] * d["K"]), fe_ops + rs_ops)
    print(f"  fused resample kernel: {kernel_ms:.4f} ms ({bound_ms / kernel_ms * 100:.1f}% of bound) {tag}")
    print(f"  two-launch split (resample.cu on the float32 rows, then the plain form on its 16 kHz "
          f"rows), timed in turns with the fused kernel: {split_ms:.4f} ms {tag}")
    print(f"  plain version (float64 two-dot resample + torch rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  library, resample and DFT only: conv1d stride {d['down']} on [{B}, {T}] {conv_ms:.4f} ms "
          f"+ torch.fft.rfft on [{B * F}, {cfg.n_fft}] {rfft_ms:.4f} ms = {conv_ms + rfft_ms:.4f} ms {tag}")
    step_times(torch, chain, batch, audio, lengths, cfg, "fused resample kernel", tag)
    results["fused"] = dict(
        launches=launches["fused"], max_abs_err=errs["max_abs"], ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=conv_ms + rfft_ms,
    )
    del framed

    # 5. resample_batch: the polyphase kernel
    x = audio.float()
    n_out = R.output_length(T, sr_in, cfg.sample_rate)
    print(f"== 5. path resample_batch float32 [{B}, {T}] {sr_in} -> {cfg.sample_rate} Hz")
    counters.zero()
    y = R.resample_batch(x, sr_in, cfg.sample_rate)
    torch.cuda.synchronize()
    launches = counters.expect("resample_batch", resample=1)
    check(tuple(y.shape) == (B, n_out) and bool(torch.isfinite(y).all()), f"output {tuple(y.shape)}, finite")
    rs_err = testing.resample_error(y, rs_kernel.resample_reference(x, sr_in, cfg.sample_rate), x)
    print(f"  kernel vs plain: max |diff| / row max |x| = {rs_err:.3e}")
    check(rs_err < testing.RESAMPLE_KERNEL_REL_ROWMAX,
          f"within {testing.RESAMPLE_KERNEL_REL_ROWMAX} of the plain version")
    x4 = batch.audio[:4].astype(np.float64)
    want = np.stack([R.resample_numpy(r, sr_in, cfg.sample_rate) for r in x4])
    sp_err = testing.resample_error(y[:4], want, x4)
    print(f"  kernel vs scipy float64 (rows 0-3): {sp_err:.3e}")
    check(sp_err < testing.RESAMPLE_KERNEL_REL_ROWMAX,
          f"within {testing.RESAMPLE_KERNEL_REL_ROWMAX} of scipy resample_poly")
    max_abs_err = float((y - rs_kernel.resample_reference(x, sr_in, cfg.sample_rate)).abs().max())
    for what, fn, exc in (
        ("float64 on the card", lambda: R.resample_batch(x[:1].double(), sr_in, 16000), ValueError),
        ("non-contiguous rows", lambda: R.resample_batch(x[:1, ::2], sr_in, 16000), ValueError),
        ("a bf16x3 matrix over the card's memory (n_fft = frame length = 131,072: 68.7 GB, "
         "folded from 137.4 GB of float64)",
         lambda: frontend.logmel_prefix(torch.as_tensor(batch.audio[:1, :16000], device="cuda"),
                                        torch.tensor([16000], dtype=torch.int32, device="cuda"),
                                        named_config("classic13").replace(n_fft=131072, win_len_s=131072 / 16000),
                                        dft_passes="bf16x3"),
         NotImplementedError),
    ):
        try:
            fn()
            raised = ""
        except exc as e:
            raised = str(e)
        check(bool(raised), f"{what} raises {exc.__name__}: {raised[:90]}")

    print(f"  times {tag}")
    kernel_ms = cuda_ms(torch, lambda: R.resample_batch(x, sr_in, cfg.sample_rate))
    plain_ms = cuda_ms(torch, lambda: rs_kernel.resample_reference(x, sr_in, cfg.sample_rate), reps=10)
    conv_ms = cuda_ms(torch, lambda: torch.nn.functional.conv1d(xpad, taps, stride=d["down"]))
    nbytes = B * T * 4 + B * n_out * 4 + d["up"] * d["K"] * 4
    bound_ms, bound_by = bound(nbytes, resample_ops(R, *R.ratio(sr_in, cfg.sample_rate), [n_out] * B))
    info = rs_kernel.kernel_info(sr_in, cfg.sample_rate)
    print(f"  polyphase kernel: {kernel_ms:.4f} ms ({bound_ms / kernel_ms * 100:.1f}% of bound), "
          f"{info['blocks_per_sm']} blocks an SM at {info['smem_bytes']} B, {info['registers']} registers, "
          f"{info['local_bytes']} local bytes {tag}")
    check(info["local_bytes"] == 0, "resample.cu: no spills")
    print(f"  plain version (float64 two-dot on the card): {plain_ms:.4f} ms {tag}")
    print(f"  library: conv1d stride {d['down']} on the zero-padded rows: {conv_ms:.4f} ms {tag}")
    results["resample"] = dict(
        launches=launches["resample"], max_abs_err=max_abs_err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=conv_ms,
    )
    del x, y, xpad, audio, lengths

    # 6. mfcc39_44k at b64 x 10 s; the fused form's dither
    cfg = named_config("mfcc39_44k")
    sr_in = cfg.input_sample_rate
    batch = make_batch(pad_batch, cfg, B, sr_in * SECONDS, 1573, seed=4)
    T = batch.audio.shape[1]
    T16 = R.output_length(T, sr_in, cfg.sample_rate)
    F = cfg.num_frames(T16)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    print(f"== 6. path mfcc39_44k b{B} x {SECONDS} s int16 [{B}, {T}] -> {T16} samples at 16 kHz")
    got = frontend.logmel_prefix(audio, lengths, cfg)
    check_prefix(testing, got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg, "main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 5), lengths, cfg)),
          "garbage past each input length leaves the output unchanged")
    check_counts(torch, frontend, audio, lengths, cfg, "mfcc39_44k")
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("main path", fused=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.RESAMPLED_FEATURE_ATOL)
    del feat, mask
    for int16 in (True, False):
        info = frontend.kernel_info(cfg, int16)
        print(f"  fused instantiation, {'int16' if int16 else 'float32'} rows: {info['registers']} registers, "
              f"{info['local_bytes']} local bytes, {info['blocks_per_sm']} blocks an SM at "
              f"{info['smem_bytes']} B")
    k44_ms, s44_ms = fused_and_split(torch, frontend, R, cfg, audio, lengths)
    e44_ms = cuda_ms(torch, lambda: chain.extract_batch(audio, lengths, cfg), reps=10)
    lens_in = np.minimum(batch.lengths.astype(np.int64), T)
    lens16 = np.array([R.output_length(int(x), sr_in, cfg.sample_rate) for x in lens_in])
    d = R.polyphase_design(*R.ratio(sr_in, cfg.sample_rate))
    rs_ops = resample_ops(R, d["up"], d["down"], lens16, cfg, F)
    print(f"  resample: {int(lens16.sum())} output samples with signal, {rs_ops / lens16.sum():.1f} FLOP each")
    b44_ms, _ = bound(frontend_bytes(cfg, frontend, lens_in, B, F, taps=d["up"] * d["K"]),
                      frontend_ops(cfg, chain, frontend, torch, lens16, F) + rs_ops)
    print(f"  fused resample kernel at 44.1 kHz: {k44_ms:.4f} ms ({b44_ms / k44_ms * 100:.1f}% of bound); "
          f"two-launch split in turns {s44_ms:.4f} ms; extract_batch {e44_ms:.4f} ms/step = "
          f"{B * SECONDS / (e44_ms / 1e3):.0f} audio-s/s {tag}")
    print("  library: none (no single PyTorch call computes a 160/441 polyphase resample)")
    del audio, lengths

    cfg = named_config("mfcc39_48k").replace(dither=0.5)
    batch = make_batch(pad_batch, cfg, B_SMALL, cfg.input_sample_rate * SECONDS, 1713, seed=5)
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    print(f"   mfcc39_48k with dither 0.5, b{B_SMALL} x {SECONDS} s int16 {list(audio.shape)}")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    counters.expect("the dithered fused form", fused=1, dither=1)
    check_prefix(testing, got, frontend.logmel_prefix_reference(audio, lengths, cfg), cfg, "main batch")
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg))
          and torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg)),
          "int16 rows == float32 rows, and two runs equal, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 6), lengths, cfg)),
          "garbage past each input length leaves the output unchanged")
    undithered = frontend.logmel_prefix(audio, lengths, cfg.replace(dither=0.0))
    check(not torch.equal(got, undithered), "the dither changes the output")
    kd_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg))
    k0_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, cfg.replace(dither=0.0)))
    print(f"  fused resample kernel at 48 kHz b{B_SMALL}: {kd_ms:.4f} ms with dither 0.5, "
          f"{k0_ms:.4f} ms without {tag}")
    del audio, lengths

    # 7. kaldi_mfcc with Kaldi's default dither: conditioning and dither
    cfg = named_config("kaldi_mfcc").replace(dither=1.0)
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B, n, 571, seed=7)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    print(f"== 7. path kaldi_mfcc dither {cfg.dither} b{B} x {SECONDS} s int16 [{B}, {T}], {F} frames")
    counters.zero()
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    counters.expect("the kernel", frontend=1, conditioning=1, dither=1)
    check(tuple(got.shape) == (B, F, M + 1), f"prefix shape {tuple(got.shape)}")
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs_d = check_prefix(testing, got, plain, cfg, "dither and conditioning, main batch")
    del plain
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg)), "two runs of one seed equal, bitwise")
    check(not torch.equal(got, frontend.logmel_prefix(audio, lengths, cfg.replace(dither_seed=1))),
          "another seed gives another draw")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 8), lengths, cfg)),
          "garbage past each length leaves the output unchanged")
    check_counts(torch, frontend, audio, lengths, cfg, "kaldi_mfcc dither 1.0")
    twin, twin_len = audio.clone(), lengths.clone()
    twin[B - 1], twin_len[B - 1] = audio[0], lengths[0]
    nv = int(chain.num_valid_frames(lengths[:1], cfg)[0])
    two = frontend.logmel_prefix(twin, twin_len, cfg)
    check(torch.equal(two[0, :nv], two[B - 1, :nv]) and torch.equal(two[0], got[0]),
          f"one utterance at rows 0 and {B - 1}: its {nv} valid frames equal, bitwise")
    del twin, two
    short = torch.tensor([0, 1, cfg.frame_length - 1], dtype=torch.int32, device="cuda")
    counters.zero()
    none = frontend.logmel_prefix(audio[:3, : cfg.frame_length - 1].contiguous(), short, cfg)
    check(tuple(none.shape) == (3, 0, M + 1) and counters.read()["frontend"] == 0,
          f"rows shorter than a frame: prefix {tuple(none.shape)}, no launch")
    cfg0 = cfg.replace(dither=0.0)
    plain0 = frontend.logmel_prefix_reference(audio, lengths, cfg0)
    errs_c = check_prefix(testing, frontend.logmel_prefix(audio, lengths, cfg0), plain0, cfg0,
                          "conditioning without dither, main batch")
    del plain0
    for source in ("windowed_frame", "pspec"):
        c = cfg.replace(energy_source=source)
        check_prefix(testing, frontend.logmel_prefix(audio[:B_SMALL], lengths[:B_SMALL], c),
                     frontend.logmel_prefix_reference(audio[:B_SMALL], lengths[:B_SMALL], c), c,
                     f"energy_source {source}, b{B_SMALL}")

    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1, conditioning=1, dither=1, tail=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, testing.KALDI_MFCC_ATOL)
    del feat, mask

    print(f"  times {tag}")
    plain_cfg = cfg.replace(remove_dc_offset=False, preemph_mode="signal", energy_source="pspec")
    kd_ms, kc_ms = in_turns(torch, [lambda: frontend.logmel_prefix(audio, lengths, cfg),
                                    lambda: frontend.logmel_prefix(audio, lengths, cfg0)])
    kn_ms = cuda_ms(torch, lambda: frontend.logmel_prefix(audio, lengths, plain_cfg.replace(dither=0.0)))
    pd_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg), reps=10)
    pc_ms = cuda_ms(torch, lambda: frontend.logmel_prefix_reference(audio, lengths, cfg0), reps=10)
    lens = np.minimum(batch.lengths.astype(np.int64), T)
    nbytes = frontend_bytes(cfg, frontend, lens, B, F)
    bc_ms, bc_by = bound(nbytes, frontend_ops(cfg0, chain, frontend, torch, lens, F))
    bd_ms, bd_by = bound(nbytes, frontend_ops(cfg, chain, frontend, torch, lens, F))
    info = frontend.kernel_info(cfg)
    print(f"  kernel with conditioning and dither 1.0: {kd_ms:.4f} ms ({bd_ms / kd_ms * 100:.1f}% of bound; "
          f"{info['blocks_per_sm']} blocks an SM at {info['smem_bytes']} B) {tag}")
    print(f"  kernel with conditioning, no dither: {kc_ms:.4f} ms ({bc_ms / kc_ms * 100:.1f}% of bound; "
          f"timed in turns with the dithered one: dither, none, none, dither) {tag}")
    print(f"  kernel without either (signal pre-emphasis, pspec energy, ln_floor): {kn_ms:.4f} ms {tag}")
    print(f"  dither adds {kd_ms - kc_ms:.4f} ms, conditioning {kc_ms - kn_ms:.4f} ms {tag}")
    print(f"  plain version with dither: {pd_ms:.4f} ms, without: {pc_ms:.4f} ms {tag}")
    print("  library: none (no PyTorch call computes the contract noise or the conditioning)")
    step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag)
    results["conditioning"] = dict(
        launches=launches["conditioning"], max_abs_err=errs_c["max_abs"], ms=kc_ms,
        plain_ms=pc_ms, bound_ms=bc_ms, bound_by=bc_by, library_ms=None,
    )
    results["dither"] = dict(
        launches=launches["dither"], max_abs_err=errs_d["max_abs"], ms=kd_ms,
        plain_ms=pd_ms, bound_ms=bd_ms, bound_by=bd_by, library_ms=None,
    )
    del audio, lengths

    for name, seed in (("kaldi_mfcc", 9), ("kaldi_fbank", 10)):
        cfg = named_config(name)
        batch = make_batch(pad_batch, cfg, B_SMALL, n, 571, seed=seed)
        print(f"   {name} (no dither), b{B_SMALL} x {SECONDS} s int16 {list(batch.audio.shape)}")
        audio = torch.as_tensor(batch.audio, device="cuda")
        lengths = torch.as_tensor(batch.lengths, device="cuda")
        check_prefix(testing, frontend.logmel_prefix(audio, lengths, cfg),
                     frontend.logmel_prefix_reference(audio, lengths, cfg), cfg, "kernel vs plain")
        counters.zero()
        feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
        torch.cuda.synchronize()
        counters.expect("extract_batch", frontend=1, conditioning=1,
                        **({"tail": 1} if cfg.features == "mfcc" else {}))
        check_features(torch, chain, testing, batch, cfg, feat, mask, testing.kaldi_feature_atol(cfg))
        del audio, lengths, feat, mask

    # 8. logmel80 at batch 256: the ln_stab epilogue
    cfg = named_config("logmel80")
    n = cfg.sample_rate * SECONDS
    batch = make_batch(pad_batch, cfg, B_LOGMEL80, n, 571, seed=11)
    T = batch.audio.shape[1]
    F, M = cfg.num_frames(T), cfg.n_mels
    audio = torch.as_tensor(batch.audio, device="cuda")
    lengths = torch.as_tensor(batch.lengths, device="cuda")
    print(f"== 8. path logmel80 b{B_LOGMEL80} x {SECONDS} s int16 [{B_LOGMEL80}, {T}], "
          f"{frontend.smem_bytes(cfg)} B of shared memory a block")
    got = frontend.logmel_prefix(audio, lengths, cfg)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (B_LOGMEL80, F, M + 1), f"prefix shape {tuple(got.shape)}")
    # at 255,744 frames the fp32 plain version is itself ~2e-5 from float64
    # on bins 40 dB below their row's max (the loud-bin gate's edge), so the
    # kernel is held to the plain version computed in float64
    plain = frontend.logmel_prefix_reference(audio, lengths, cfg)
    errs32 = testing.prefix_errors(got, plain, M, cfg.log_kind)
    print("  kernel vs the fp32 plain version: " + ", ".join(f"{k}={v:.3e}" for k, v in errs32.items()))
    plain64 = frontend.logmel_prefix_reference(audio, lengths, cfg.replace(dtype="float64"))
    errs = check_prefix(testing, got, plain64, cfg, "ln_stab, main batch, vs the float64 plain version")
    errs64 = testing.prefix_errors(plain, plain64, M, cfg.log_kind)
    print("  the fp32 plain version vs float64: " + ", ".join(f"{k}={v:.3e}" for k, v in errs64.items()))
    del plain, plain64
    check(torch.equal(got, frontend.logmel_prefix(audio.float(), lengths, cfg)),
          "int16 rows == the same rows in float32, bitwise")
    check(torch.equal(got, frontend.logmel_prefix(dirty_rows(torch, audio, lengths, 12), lengths, cfg)),
          "garbage past each length leaves the output unchanged")
    del got
    counters.zero()
    feat, mask = chain.extract_batch(batch.audio, batch.lengths, cfg)
    torch.cuda.synchronize()
    launches = counters.expect("main path", frontend=1)
    check_features(torch, chain, testing, batch, cfg, feat, mask, None)
    del feat, mask
    cdb = cfg.replace(log_kind="db")
    check_prefix(testing, frontend.logmel_prefix(audio[:B_SMALL], lengths[:B_SMALL], cdb),
                 frontend.logmel_prefix_reference(audio[:B_SMALL], lengths[:B_SMALL], cdb), cdb,
                 f"db epilogue, b{B_SMALL}")

    print(f"  times {tag}")
    kernel_ms, plain_ms, rfft_ms = kernel_times(torch, chain, frontend, cfg, audio, lengths, F, 5)
    lens = np.minimum(batch.lengths.astype(np.int64), T)
    bound_ms, bound_by = bound(frontend_bytes(cfg, frontend, lens, B_LOGMEL80, F),
                               frontend_ops(cfg, chain, frontend, torch, lens, F))
    print(f"  frontend kernel, ln_stab, M = {M}: {kernel_ms:.4f} ms "
          f"({bound_ms / kernel_ms * 100:.1f}% of bound) {tag}")
    print(f"  plain version (torch rfft chain on the card): {plain_ms:.4f} ms {tag}")
    print(f"  torch.fft.rfft(n={cfg.n_fft}) on [{B_LOGMEL80 * F}, {cfg.frame_length}] pre-framed "
          f"(DFT only): {rfft_ms:.4f} ms {tag}")
    step_times(torch, chain, batch, audio, lengths, cfg, "front-end kernel", tag)
    del audio, lengths

    # 9-11. kaldi_plp, kaldi_spectrogram, ssc26: the feature kinds
    for phase, (name, seed) in enumerate(FAMILY_PATHS, start=9):
        feature_kind, numbers = family_path(torch, counters, name, seed, phase, tag)
        results[feature_kind] = numbers

    # 12-18. whisper80, centered framing, the Bluestein form and other Stockham sizes,
    # long frames and long rows
    results["whisper"] = whisper_path(torch, counters, tag)
    new_form_paths(torch, counters, tag, results)

    # 19-20. the feature tail's branches; the bf16x3 form
    tail_paths(torch, counters, tag)
    cuts = breakdown.bind_cuts(cut_builds, frontend._lib())
    results["bf16x3"] = bf16x3_path(torch, counters, tag, breakdown, cuts, builds["frontend"][0])
    large_fft_path(torch, counters, tag)

    # 22-25: the corpus path, streaming and serving, the training path, the
    # tools (which convert phase 22's shards) in one temporary directory
    with tempfile.TemporaryDirectory() as work:
        work = pathlib.Path(work)
        corpus_path(torch, counters, tag, args.seed, work)
        serving_path(torch, counters, tag, results)
        training_path(torch, counters, tag, results)
        tools_path(torch, tag, work)
    resampled_rows_path(torch, counters, tag, results)
    large_n_fft_path(torch, counters, tag, results)
    long_span_path(torch, counters, tag, results)
    any_n_fft_path(torch, counters, tag, results)
    bf16x3_plans_path(torch, counters, tag, results)
    many_filters_path(torch, counters, tag, results, t_script, breakdown, cuts)
    print(f"the whole script took {time.perf_counter() - t_script:.1f} s")

    print(card)
    print(json.dumps({"kernels": [{**KERNELS[k], **results[k]} for k in KERNELS
                                  if k in results or k not in HOST_BOUND_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
