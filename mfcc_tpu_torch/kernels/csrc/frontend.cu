// Fused MFCC front-end for Hopper (sm_90a): audio rows -> [log-mel | energy].
//
// Replaces mfcc_tpu/kernels/frontend.py::_make_radix4_kernel (:905), slab
// mode, launched from _fused_logmel_energy (:1295) through pl.pallas_call
// (:1552), at N2 = 128 and at whisper80's N2 = 100 with the host reflect
// extension _reflect_extend (:1572-1640) and the log10_floor epilogue
// (:701); _make_kernel (:807-897) with kernel_constants (:160-241), the
// DFT of the fp32 dft_passes route, for the sizes radix-4 cannot tile and
// at any n_fft for the fp32 route (here the full-fp32 Stockham or
// Bluestein form of the size, a frame a warp or, at large sizes, a frame a
// block); the bf16x3 route on the tensor cores
// (wgmma), in both forms, at any n_fft, hop and frame length; and the
// dither, frame-first conditioning, log-kind and PLP,
// spectrogram and SSC branches. Plain version and wrapper:
// mfcc_tpu_torch/kernels/frontend.py (logmel_prefix_reference,
// logmel_prefix).
//
// Per utterance b and frame f < F (default branches; N = n_fft):
//   x[t]   = float(audio[b, t]) * scale              (int16 or float32 rows)
//   y[t]   = x[t] - c * x[t-1], x[-1] = 0; then y[t] = 0 for t >= lengths[b]
//   X[k]   = rfft(y[f*S + o : f*S + o + L] * window, n=N)  (zero past T, and
//            past N for frames longer than N; o = 0 unless centered)
//   P[k]   = |X[k]|^2 * pscale                       (k < N/2 + 1)
//   out[b, f, m] = ln(where(mel_m <= 0, eps, mel_m)), mel_m = sum_k P[k] mel[k, m]
//   out[b, f, M] = where(E <= 0, eps, E),             E = sum_k P[k] (unlogged)
// The dither, conditioning, framing, DFT and log-kind branches are
// described below.
//
// Bound at the main path (classic13_deltas, batch 64 x 10 s, int16 rows,
// T = 160,080, F = 999, M = 26; H100 SXM peaks):
//   bytes: 20.49 MB int16 in + 6.90 MB out = 27.4 MB -> 8.2 us at 3.35 TB/s.
//   operations, the function's minimum: 0.4 k window + 6.66 k for a
//     split-radix 256-point complex FFT (4N log2 N - 6N + 8) + 1.78 k real
//     split (its 1/2 scalings fold into pscale) + 0.77 k |X|^2 + 0.92 k mel
//     (the 459 nonzero weights) + 0.26 k energy + 53 clamp/ln = 10,839 FLOP
//     per frame x 56,836 frames that hold samples, plus 2 per sample of
//     pre-emphasis = 0.634 GFLOP -> 9.47 us at 67 TFLOP/s fp32. The
//     operations set the bound; chip_smoke.py computes it from each run's
//     inputs.
// Neither bytes nor operations bind this kernel on Hopper. A frame is
// about a thousand warp instructions of shared-memory passes, index
// arithmetic and butterflies, run as a chain of dependent passes (load ->
// butterfly -> store -> __syncwarp, once per FFT stage), so it is bound by
// instruction issue and shared-memory throughput per SM, and by the passes'
// latency where too few warps are resident. The design cuts each: three
// FFT passes at 256 points where radix 2 took eight, three blocks (24
// warps) an SM, the projection spread evenly over the lanes with its logs
// off the divergent loop, no DFT for frames of zeros, and the staging
// loads issued in batches. PERF.md section 6 gives the measured breakdown
// (staging, DFT and split, projection).
//
// Design. One block per (utterance, tile of 32 frames), 8 warps:
//   1. The tile's sample span, 31*S + L samples (5,360 at S = 160, L = 400),
//      is staged once in shared memory as fp32 after convert, pre-emphasis
//      and zeroing, each thread issuing the loads of kStageBatch samples
//      before it uses any, so their latencies overlap. Each input byte is
//      read about once (the overlap
//      between tiles and the x[t-1] re-read are served by L1/L2);
//      pre-emphasis reads the previous tile's last sample from global
//      memory, so only t = 0 sees x[-1] = 0. Zeroing follows pre-emphasis,
//      so y[length] = 0, and it does not rely on the padding being zero.
//      Under non-centered framing a tile that starts at or past its row's
//      length stages nothing (all its frames are zero frames, step 2z).
//   2. Each warp takes one frame at a time (the warp plan; the block plan,
//      below, has the whole block take each frame in turn).
//   2z. A frame that starts at or past its row's length (non-centered
//      framing, both forms) holds only zeros by construction, so it takes
//      no DFT: its power row is set to 0, exactly what the DFT of its zero
//      samples gives, and the conditioning's mean and energy are 0. Step 4
//      runs on that row. (11 % of the main path's frames.)
//   3. The DFT, by a warp-uniform switch on the form the host picked from N
//      (no template flag):
//      (a) the Stockham (autosort) FFT, for every even N whose half H = N/2
//          factors into 8s, one 4 or 2, 3s and 5s (256 = 8*8*4: three
//          passes; whisper80's 200 = 8*5*5; 240 = 8*2*3*5): the frame is
//          H complex points z[n] = y[2n] + i y[2n+1]. Stage s of radix R
//          after ns points: butterfly j < H/R reads its R inputs
//          j + r H/R, twists input r by e^{-2 pi i r k/(ns R)}, k = j mod
//          ns, takes the R-point DFT in registers (radix 8 as two radix-4
//          DFTs and the W8 twists) and writes (j - k) R + k + r ns. The
//          last stage leaves natural order: no digit reversal, no __brev.
//          Stage 0 reads its inputs straight from the staged signal, the
//          window (and the conditioning) applied on the way, so the frame
//          is never packed; each later stage reads the row the one before
//          wrote, ping-ponging between the warp's two rows. The twists and
//          each butterfly's output base (j - k) R + k come from host tables
//          per stage (float64 rounded once), so no butterfly takes a
//          remainder or a sincosf. Rows are padded by one float2 after
//          every 8 (index i at i + i/8): stage 0's stride-8 stores, 8-way
//          bank conflicts in a plain row, spread over 16 banks.
//      (d) every other N, odd ones included: the Bluestein FFT (it replaced
//          the O(N * bins) direct sum the fp32 route took there). It
//          computes the first K outputs of a Q-point DFT as a chirp-z
//          convolution through a P-point Stockham FFT on the same
//          stages as (a): even N packs the frame as in (a) (Q = K = H, then
//          the real split); odd N transforms its N real samples (Q = N,
//          K = N/2 + 1), one frame at a time, at P >= N + K - 1 (two frames
//          as one complex sequence would need P >= 2N - 1 and rows that do
//          not fit 8 warps beside the span at N = 551). P is the cheapest size
//          >= Q + K - 1 the stages take: fewest stages, then fewest points
//          (404: P = 512 = 8*8*8, three passes; 551: 960 = 8*8*3*5). With
//          the chirp c[n] = e^{-i pi n^2/Q} (n^2 mod 2Q an exact integer on
//          the host): the forward FFT's stage 0 loads a[n] = z[n] c[n] for
//          n < Q straight from the staged signal (windowed, conditioned),
//          0 past Q; the inverse FFT's stage 0 loads conj(A[n]) B[n], B the
//          filter spectrum conj(FFT(b))/P of b[m] = conj(c[m]) on m in
//          (-Q, K) (1/P folded in; for even N b is even, so only B[0 .. P/2]
//          is staged and read at min(n, P - n)), and runs the same forward
//          stages, which leave the conjugate of the convolution; Z[k] =
//          c[k] conj(D[k]) then feeds the real split (even N) or is X[k]
//          (odd N). Two FFTs of P points a frame against a direct sum's
//          N * bins lookups; the error grows as log P.
//      No direct DFT is left: every N takes (a) or (d), in the warp plan or
//      the block plan (below).
//      Every table is computed on the host in float64; every sum is fp32
//      FMA: no TF32, no bf16 (1-pass reduced precision breaks the 1e-4
//      log-mel gate, docs/KERNEL.md section 3). For (a) and even-N (d) the real split gives
//      X[k] and X[H-k] from Z[k] and Z[H-k] (k <= H/2) into the free row,
//      summing the powers on the way (the pspec energy). Rows are indexed
//      by bin in every form.
//   4. The projection over packed mel bands: the host packs each filter's
//      nonzero band [lo, hi) filter after filter (459 weights at
//      classic13, 1.8 KB, where the dense [257, 26] matrix took 26.7 KB),
//      with per-filter offsets and, per weight, one word holding its bin
//      (all 31 bits) and, in the sign bit, whether it is the filter's last:
//      no word names a filter, so no filter count is refused. The packed weights
//      are cut evenly over the warp's lanes, c = ceil(nnz/32) rounded up to
//      odd (15 at classic13; an odd stride puts the lanes' first weights in
//      32 banks): lane l sums [l c, l c + c) one weight at a time, storing
//      the sum of every filter that ends in its chunk to the warp's sum row
//      and posting the partial of the one that goes on; a filter that began
//      in an earlier lane a is summed by the lane it ends in, as part[a] +
//      ... + part[l-1] + its own sum, in that order, so two runs are
//      bitwise equal. Each lane finds the filter its chunk starts in once a
//      tile, by a binary search of the offsets for its first weight
//      (filter_of: log2(M + 1) loads, where a per-chunk table from the host
//      would need one for each plan's chunk and a pointer more in the C
//      interface), and counts one filter on at each sign bit. The loop's
//      only branch stores a sum; the clamp and log (or nothing for plp, or
//      the SSC ratio) follow lane-parallel over the sum row, with lane M's
//      energy. Nothing but the [F, M+1] prefix reaches device memory.
//
// Shared memory (floats, every offset 16-byte aligned; kernels/frontend.py
// smem_bytes mirrors it): the signal row (one more float in the fused
// resample and under dither: x[t0-1 .. t0+span)), the window, the packed weights (mel; melf
// after it for ssc), the filters' offsets [M+1] and the weights' bin
// words, the twiddles (the split's N/4 + 1 entries, then each later stage's
// (H/R)(R - 1) twists), the stages' output bases, then per warp its two
// rows and its projection scratch (32 lane partials and M sums; twice for
// ssc; none for a spectrogram), which the fused resample's input window
// overlays (widening them only where it is longer), then the resample's
// taps. classic13 takes 71,200 B, logmel80 73,184, whisper80 62,832, ssc26
// 74,832, kaldi_mfcc with dither 71,232: three blocks an SM (24 warps) for
// each.
// The Bluestein form's table holds the split, the P-point stages' twists,
// the chirp and the filter spectrum, its bases the P-point stages', its
// rows P + P/8 + 1 float2: 114,384 B at classic13 n_fft 404, two blocks an
// SM; 201,264 B at 551, one.
// __launch_bounds__(256, 3) caps the warp plan at 80 registers a thread.
//
// The block plan (kBlock; plan() and plan_block pick it, kernels/frontend.py
// fft_layout mirrors them; the plain form only) where the warp plan's
// layout is over the block's 227 KB: at 26 filters every Bluestein N from
// 685 and every Stockham N from 2,160; librosa's 2,048-point frames at
// 22.05 kHz, 270,368 B in the warp plan. At large P the eight warps' own
// rows are what does not fit, so the block's 256 threads form 4, 2 or 1
// groups (p.groups), and each group transforms its share of the tile's 32
// frames one at a time through two rows of its own (P + P/8 + 1 float2
// each): the same Stockham stages, butterfly j < P/R of a stage taken by
// the group's thread j, j + 256/groups, ..., the group meeting at its named
// barrier (bar.sync 1 + group) between stages and between the Bluestein
// form's two FFTs; the real split and the powers over the group's threads;
// the frame's conditioning and energies as group sums (each warp's shuffle
// sum, then the group's warps' in order, so two runs are bitwise equal); the
// projection over the packed bands cut into chunks of c = ceil(nnz /
// (256/groups)) rounded up to odd, summed as step 4 sums a warp's 32. Step
// 2z and the counts and mask are as in the warp plan. The tables
// (twiddles, chirp, filter spectrum, stage bases) are staged where the
// layout fits, else read from device memory (one table pointer a block,
// plain loads; "gather_rows" by __ldg, below). plan_block takes the first
// of 4, 2 and 1 groups with the tables staged, then 4, 2 and 1 with them in
// device memory, that fits (at classic13: 1,102 four groups staged,
// 168,080 B; 4,096 two, 198,144 B; 2,501 two from device memory; 5,392 one
// from device memory, 195,584 B).
// From n_fft 5,393 the Bluestein rows (P = 8,192) are over the block in
// every plan. More frames in flight an SM is what pays, and first-fit
// stays within 15 % of the best choice at each size measured
// (scripts/block_plan_sweep.py times every choice; PERF.md section 6). A
// size the warp plan fits keeps the warp plan, whose code and bits are as
// before.
// Bound at classic13 n_fft 1,102, b16 x 10 s: the function's minimum (a
// 551-point complex FFT counted by the split-radix formula, the split,
// |X|^2, the mel sums, the logs) is ~0.006 ms: operations bound it. The
// plan does two 1,280-point FFTs a frame, four frames a block at a time at
// one block an SM, a barrier a stage: it is bound by the stages' latency
// (a few butterflies a thread a stage), not by the card's rate.
// __launch_bounds__(256, 2): at most 128 registers a thread.
//
// The gather plan (p.gather, a run-time branch of the block plan's
// instantiations; plan_block tries it only after every block plan above
// fails, so a config that fits those keeps its plan and its bits). The
// staged span, (32 - 1) S + L floats, and the window, max(L, n_fft), grow
// with the hop and the frame length, not with n_fft: at a hop of 0.125 s
// (2,000 samples) or frames of 1.6 s they alone are over the block. The
// gather plan stages neither. Each group builds its frame straight from the
// row in device memory into its second FFT row (step 2g), the row stage 0
// of the first FFT reads and never writes: for a < min(L, n_fft) the value
// the staged span would hold at t = f S + a (staged_at: the int16 or float32
// convert, signal pre-emphasis from x[t-1] (0 only at t = 0; under origin 1
// the pre-context sample), zeroing at t >= length after pre-emphasis; under
// kDither the contract noise keyed on each sample's source index; under
// centered framing the same reflection index), and the window read from
// device memory (the DFT's loads through one window pointer a block, staged
// or not: a choice at each load cost the staged block plan 4-11 % in turns,
// scripts/block_plan_sweep.py --parent). Under kCond the mean and the raw
// energy are group sums over all L samples in the order the staged block
// plan sums them (those past n_fft from device memory), and the windowed
// energy past n_fft reads device memory too. Step 2z stays; the tables are staged where they fit, else read
// from device memory (p.tables_global) as in "block_global". Shared memory
// then holds the packed bands, the tables where staged, and each group's two
// rows and scratch: it no longer depends on the hop or the frame length.
// plan_block takes the first of 4, 2 and 1 groups, tables staged, then in
// device memory, that fits (classic13_deltas at any hop or frame length:
// four groups, 28,736 B; librosa's 8,192-point frames at hop 2,048: one
// group, its tables staged, 230,432 B; n_fft 6,001: one group, its tables in
// device memory, 230,912 B). Each sample of a frame is read from L2 by every
// frame that holds it (L / S frames; one at hops of a frame or more), and its
// x[t-1] once more under signal pre-emphasis: the plan trades those reads for
// the layout's independence of the hop and the frame length.
// Bound at librosa's 8,192-point framing (22.05 kHz, hop 2,048, 128 mels,
// b64 x 30 s int16, 20,672 frames): bytes 84.7 MB in + 10.7 MB out -> ~28 us;
// operations ~0.2 MFLOP a frame at the function's minimum (a 4,096-point
// complex FFT by the split-radix formula, the split, |X|^2, the mel sums) ->
// ~60 us: operations bound it (chip_smoke.py computes it per run). One frame
// a block at once, one block an SM, a barrier a stage: like the block plan,
// it is bound by the stages' latency, not by the card's rate.
//
// The plans past the gather plan's layouts ("gather_bands", "gather_rows":
// p.bands_global and p.rows_global, run-time branches of the same kBlock
// instantiations, tried last in plan_block's ladder, kLadder). The gather
// plan still stages the packed mel bands beside each group's two FFT rows:
// at n_fft 16,384 and 26 filters the bands are 124 KB of 272,736 B, and from
// n_fft 6,205 at classic13 (the Bluestein rows of P = 10,240) the two are
// over the block. "gather_bands" is "gather_global" with the mel weights,
// SSC's melf weights, the filter offsets and the bin words read from
// device memory through one Bands of pointers a block: shared memory holds
// each group's two rows, its projection scratch and the warps' partials. It
// takes Stockham sizes to n_fft 25,600 (h = 12,800: 231,600 B at
// classic13) and Bluestein sizes to P = 12,800 (7,001: 222,384 B; 12,502:
// 231,600 B). "gather_rows" also keeps each
// group's two rows, and the power row they hold, in a workspace in device
// memory that the wrapper allocates (kernels/frontend.py rows_workspace).
// Its grid is persistent: as many blocks as the card holds at once (its
// SMs times the blocks an SM holds, at most the batch's tiles), block i
// taking tiles i, i + gridDim.x, ... of the batch one after another, with
// slot i of groups x 2 rows its own. So no two blocks share rows, no block
// waits for another, and the workspace is bounded by the card, not by the
// batch. The rows are read with plain (coherent) loads, never __ldg: the
// group writes them, and its named barrier orders its stages; each entry is
// written before it is read, so what the workspace held never reaches the
// output. The kernel calls the tile (logmel_tile) from one place, with p
// and pp grid constants it reads in place; the same loop written inline
// around the kernel's body spilled in four instantiations and cost the
// block plan 1.06-1.13x in turns, and a lambda around the call put 600 B of
// stack on the block plan's dither and conditioning instantiation. The
// group's frame loop has two copies, as before: "gather_rows"
// (GroupTeam<true>: its rows
// in the workspace, its tables by __ldg), and every other block plan
// (GroupTeam<false>: its rows staged; its tables and bands through pointers
// chosen once a block, so generic loads). Choosing the rows' pointer once a
// block instead cost "block_global" 1.06x at n_fft 2,501; the tables'
// pointer costs the staged block plan 1.03-1.04x at 1,102 and 4,096, bitwise
// (scripts/block_plan_sweep.py --parent; PERF.md section 6), and
// moves the last bits of kaldi_mfcc with dither at n_fft 1,102 (at most
// 1.8e-5; its instantiation sits at the 128-register cap); a third copy
// moved the staged block plan's bits. Shared memory holds only the
// groups' projection scratch and the warps' partials: 1,504 B at classic13
// whatever n_fft, four frames a block at once.
// Bound of "gather_rows" at classic13_deltas n_fft 32,768, b16 x 10 s
// (~16,000 frames): ~1.0 MFLOP a frame at the function's minimum (a
// 16,384-point complex FFT by the split-radix formula, the split, |X|^2, the
// mel sums) -> ~0.24 ms at 67 TFLOP/s; bytes ~7 MB -> ~2 us: operations
// bound it (chip_smoke.py computes it per run). The plan moves each stage's
// row through L2, and through HBM where the resident slots' rows are over
// L2's 50 MB (at n_fft 32,768, 264 slots of 4 x 2 rows of 147 KB): its
// stages are bound by those round trips, not by the card's rate.
//
// The plan past "gather_rows" ("gather_sums": p.sums_global, a run-time
// branch of "gather_rows"' copy of the group loop, GroupTeam<true>, so the
// staged plans' code is not touched; tried last in kLadder). "gather_rows"
// still stages each group's projection scratch: 256 / groups thread
// partials and the M filter sums, twice for SSC. At one group that is over
// the block from 57,849 filters (mfcc and log-mel kinds) and from 28,797
// (SSC). "gather_sums" keeps the partials staged and puts the sums in
// device memory: the filter sums in the frame's own output row, out[b, f,
// 0:M), where the log kind (or nothing for plp, or the centroid ratio) is
// then taken in place, each lane over the filters it finishes; SSC's melf
// sums in the workspace after the slots' rows (kernels/frontend.py
// rows_workspace: groups x M floats a slot, one slot a block of the
// persistent grid, so it does not grow with the batch). Only the block's
// own threads write and read those rows, and the group's named barrier
// (bar.sync, like __syncthreads for the threads it joins) orders a sum's
// store before any other thread's load: a block reads back its own writes
// with no grid-wide fence. The sums are added in the same order as in
// every other plan, so the output is bitwise what "gather_rows" gives
// where both fit. Its layout, the partials and the warps' partials, is
// 1,056 B whatever the groups and M (2,080 B for SSC): every filter count
// fits, and plan_block takes it at four groups. Bound at classic13_deltas with 60,000 filters, b16 x 10 s: the
// output, 16 x 999 x 60,001 floats (3.84 GB) written once, is ~1.15 ms at
// 3.35 TB/s; bytes bound it (chip_smoke.py computes it per run).
//
// The wide plan (p.wide; logmel_kernel_wide, instantiations of its own, its
// tile p.tile a launch argument; kernels/frontend.py fft_layout takes it
// where the ladder without it gives "gather_sums", and "gather_bands" or
// "gather_rows" at WIDE_MIN_FILTERS filters or more; plan_wide lays it out,
// kernels/frontend.py wide_smem mirrors it). At tens of thousands of
// filters each filter has one weight (60,000 filters at n_fft 512: 60,000
// packed weights), so the projection is a gather, a product and a log a
// lane, and the work is writing the [B, F, M + 1] output once. "gather_sums"
// wrote it three times (each sum a lone 4-byte store, the row read back for
// the log and written again) and "gather_bands" took one frame an SM. A
// block takes a tile of p.tile frames of one row:
//   stage 1, the FFT: the block's p.groups groups (the first of 4, 2, 1
//     whose two rows fit beside the tile's power rows) take the tile's
//     frames one at a time through their rows in shared memory, as the
//     gather plans' groups do (step 2g, the conditioning's group sums, the
//     Stockham or Bluestein stages with the tables by __ldg, the real split
//     or the odd form's powers), but into the frame's own power row of the
//     tile, stride pws = bins rounded up to 4, and its energy lane into en;
//   stage 2, the projection filter by filter: thread t takes filters t,
//     t + 256, ..., reads each one's weights (off, meta, w, and wf for SSC)
//     once a tile, and for each frame sums them in packed order from 0 (one
//     rounded product where the filter has one weight), takes the epilogue
//     (WideFinish: the log kind, nothing for PLP, the SSC ratio) in
//     registers and stores the lane once (st.global.cs: a warp's 32 lanes
//     are one run of the row); lane M takes en.
// Nothing but the output reaches device memory: no sums there, no thread
// partials, no second pass, no workspace. With one weight a filter each sum
// is the one rounded product every plan computes, so where the groups are
// "gather_sums"' (4) the output is bitwise its, and elsewhere it differs in
// the energy lane alone (a group sum over other threads). The tile is the
// most frames whose layout fits two blocks an SM, else one (93 at n_fft
// 512, 10 at ssc26's 4,096); the wrapper may launch fewer a block (the
// tile is an argument). Past one frame's power row beside the FFT rows
// (n_fft from ~21,000) "gather_sums" stays.
// Bound at classic13_deltas with 60,000 filters, b16 x 10 s: the output,
// 3.84 GB written once, ~1.15 ms at 3.35 TB/s (chip_smoke.py computes it
// per run).
//
// The cluster plan (p.cluster = C; logmel_kernel_cluster, instantiations
// of its own, launched by cudaLaunchKernelEx with the cluster dimension as
// a launch attribute; the wrapper asks for it by its cluster size, a
// launch argument, where kernels/frontend.py fft_layout takes it, after
// "gather_global" and before "gather_bands" at its size rule; plan_cluster
// lays it out, kernels/frontend.py cluster_smem mirrors it). "gather_bands" and "gather_rows" ran one frame a group through rows
// in shared memory or in device memory: at n_fft 32,768 each Stockham
// stage's 147 KB row went through L2 and HBM (the slots' rows are over
// L2), at librosa's 16,384 one frame an SM waited on each stage's dependent
// loads. A thread-block cluster of C = 2, 4 or 8 blocks (portable sizes;
// the smallest whose layout fits) holds each frame's two FFT rows in the
// shared memory of its C blocks, 1/C of each row a block (rank r of the
// cluster), read across the cluster through distributed shared memory
// (cooperative_groups map_shared_rank, ld/st.shared::cluster):
//   3k. a four-step split of the form's n-point FFT, n = C H2: rank r
//       transforms its points g = C n' + r (n' < H2) by the Stockham stages
//       of an H2-point FFT, stage 0 loading them from device memory (the
//       gather plan's staged_at: pre-emphasis, zeroing, the dither keyed
//       on the source index, the reflection; the conditioning's mean and
//       energies as cluster sums), each stage under __syncthreads;
//   3x. the exchange, the one pass across the cluster: butterfly k1 < H2
//       reads Y_r[k1] of every rank, twists it by e^{-2 pi i r k1 / n}
//       (the host's float64 table), takes the C-point DFT and stores output
//       q, X[k1 + q H2], to rank q: rank q then holds X[q H2, (q + 1) H2)
//       in order; the Bluestein form does this twice, its inverse's stage
//       0 reading conj(A[g]) from the rank that holds A[g];
//   3s. the real split reads its partners Z[H - k] from the ranks that hold
//       them and stores each power to the rank that holds its bin (rank
//       k / pb, pb = ceil(bins / C));
//   4c. each rank sums the packed weights of its own bins over the filters
//       its bins touch (found once a launch from each filter's first and
//       last bin: 4r), balanced over its 256 threads as a block plan's
//       group sums them, a weight of another rank's bin adding nothing;
//   4m. filter m is completed from the partials of the ranks it touches in
//       rank order, and its log kind (or the PLP sum, or the SSC ratio)
//       taken, by the rank that owns it (m = r 256 + thread, then on by C
//       256); the energy is the ranks' power sums in rank order. So two
//       runs are bitwise equal.
// The cluster meets (barrier.cluster arrive.release / wait.acquire) after
// the local stages, after each exchange, after the powers, after the
// partials and at the frame's end; a frame that starts past its row's
// length takes no FFT (step 2z). The grid is persistent: as many clusters
// as the card holds at once (cudaOccupancyMaxActiveClusters, the wrapper's
// nslots), cluster i taking frames i, i + clusters, ... of the batch, so
// no workspace. Shared memory a block (cluster_layout): its two rows of H2
// points (padded as every plan's), the 256 thread partials and M filter
// partials a weight table, the warps' partials, 4 slots and the ranks'
// filter ranges: at classic13_deltas n_fft 32,768, C = 2, 148,736 B (one
// block an SM); 65,536 C = 4, 131,072 C = 8, 148,736 B; 116 registers, so
// two blocks an SM at most (librosa's 16,384 at 44.1 kHz, C = 2, 75,408 B).
// The size rule (kernels/frontend.py CLUSTER_MIN_POINTS, by form), from
// chip_smoke.py phase 29's turns (PERF.md section 6): the plan beat
// "gather_rows" at every size (0.36-0.73x of its time); against
// "gather_bands" it won or tied in the Stockham form at 8,192 points
// (librosa's 16,384 b64 x 30 s 0.76x, whisper80's b16 x 10 s 1.00x) and
// lost in the Bluestein form at P = 12,800 (12,502: 1.38x), so it takes
// Stockham FFTs from 8,192 points and Bluestein FFTs from P = 16,384. The tables (local twists, the
// Bluestein chirp and filter spectrum, the exchange's twists) and the
// packed bands are read from device memory by __ldg (staging them beside
// the rows is left for later). The output is within the kernel-vs-plain
// gates of the other plans', not bitwise theirs (other summation orders).
// Bound, at classic13_deltas n_fft 32,768 b16 x 10 s as "gather_rows"'
// above: operations (~0.24 ms at 67 TFLOP/s; chip_smoke.py computes it per
// run). The rows no longer round-trip through L2 and HBM; what bounds the
// plan now is latency: one frame a cluster and 8 warps an SM, so the
// frame's loads from device memory, each stage, the exchange, the split's
// remote reads and the projection's loads wait in turn (PERF.md section 6
// breaks it down).
//
// Centered framing (center != 0; replaces _reflect_extend :1572-1640 and
// its host twin, which write a reflect-extended float32 slab). Frame f
// starts at f*S + o, o = S/2 - L/2 ("center", Kaldi snip_edges=false) or
// -(L/2) ("center_reflect", torch.stft center=True); no extension pass
// and no host rows: the staged position t = f0*S + o + i maps to the
// source index r = reflect(t, max(len, 1)) (ops/chain.py reflect_index,
// any number of wraps), and the kernel reads row[r] as int16 or float32.
// The reference pre-emphasizes, dithers and zeroes the flat signal before
// it reflects, so the staged value is y[r] = x[r] - c x[r-1] at the SOURCE
// index (x[-1] = 0, the noise keyed on r, y = 0 for a length-0 row), not
// the difference of two staged neighbours, which differ at the seams.
// Reflected frames hold samples, so centered framing skips no frame.
//
// The block launch (mfcc_frontend_logmel at origin 1; port of the
// streaming base block, mfcc_tpu/pipeline/streaming.py:51-139, which the
// reference computes with jnp stages, not a Pallas kernel). Streaming
// (mfcc_tpu_torch/pipeline/streaming.py) extracts a stream K frames at a
// time from a window of span + 1 samples, span = (K - 1) S + L, whose
// sample 0 is the pre-context x[t0 S - 1] (0 at the stream's start) and
// whose samples past `valid` are padding. Row b is that window, F = K and
// lengths[b] = valid; the row's signal starts at row sample 1, which the
// staging reads as x[0], and row sample 0 only as x[-1]:
//   y[t] = x[t] - c * x[t-1] for 0 <= t < valid, x[-1] = row[0]; y[t] = 0
//          for t >= valid; frame f = y[f S .. f S + L)
// and the rest as above. Frame-first (Kaldi) pre-emphasis (c = 0 here)
// never reads the pre-context. No dither, no centered framing, no bf16x3
// form (streaming refuses the first two; the third is an opt-in of the
// offline route). The launch's n_valid and mask are those of `valid`, not
// the stream's counts, which streaming keeps on the host. Each row is
// computed by its own blocks, so a stream's prefix does not depend on the
// other rows of the launch.
//
// Bound at whisper80 (batch 64 x 30 s int16, all lengths 480,000, T =
// 480,240, F = 3,000, M = 80, N = 400): bytes 61.4 MB in + 62.2 MB of
// [64, 3000, 81] out = 123.6 MB -> ~37 us; operations ~8.6 k a frame at the
// function's minimum (a 200-point complex FFT counted by the split-radix
// formula, the real split, |X|^2, 80 Slaney filters over their nonzero
// weights, 80 log10 and the energy) x 192,000 frames ~ 1.65 GFLOP -> ~25
// us: bytes bound it, a little. chip_smoke.py computes both from each
// run's inputs.
//
// Fused resample (kResample; entry mfcc_frontend_logmel_resample). Replaces
// the in-kernel resample of mfcc_tpu/kernels/frontend.py::_gather_frames
// (:493-529, two fp32 dots over blocked sr_in rows). The rows are at sr_in
// (T and lengths[b] in input samples); x above is the sr_in signal
// resampled by the polyphase FIR of polyphase.cuh (scipy resample_poly,
// zero padding), with input_scale folded into the taps:
//   x[t]   = sum_i tab[p(t), i] * in[q(t) - i],  in[u] = 0 unless 0 <= u < lengths[b]
//   y[t]   = x[t] - c * x[t-1] with x[-1] = 0; then y[t] = 0 for
//            t >= ceil(lengths[b] * up / down)
// Staging becomes: the tile's input window (pp_window of span + 1 outputs:
// 16,146 samples at 48 kHz, 14,830 at 44.1 kHz) in the rows' own type
// (int16 rows stay int16, 32.3 KB at 48 kHz) over the warps' Stockham rows,
// which stand idle until the DFT (39 KB at n_fft 512), and the tap table
// at polyphase.cuh's padded stride; then polyphase.cuh's register-blocked
// FIR (7 consecutive outputs a thread at 48 kHz, 4 outputs 160 apart at
// 44.1 kHz) writes x[t0-1 .. t0+span) into the signal row (only t < the
// output length; dithered there under kDither), then pre-emphasis and
// zeroing in place. Each x[t-1] is the row's previous entry, so no second
// x row is kept. The resampled signal never reaches device memory. Frames
// past the output length take step 2z. Shared memory with int16 rows:
// 71,472 B at 48 kHz (three blocks an SM, as the plain form), 107,696 B at
// 44.1 kHz (the 160 x 57 tap table; two); float32 rows widen the window
// past the rows: 97,040 B at 48 kHz (two), 128,000 B at 44.1 kHz (one).
// No centered framing: centered resampled rows, and every config whose fused
// layout with float32 rows is over the block (192 kHz input: 291,536 B),
// take the split route instead (kernels/frontend.py resample_route, picked
// by the layout mirror before any launch): resample.cu on the rows, zeroed
// past each length and writing each row's output length, then the plain form
// of this file on its 16 kHz rows (the reference's unfused route,
// mfcc_tpu/ops/chain.py:734-764, whose kernel dithers, reflects and frames
// the resampled rows, frontend.py:1852-1862: the plain form's centered
// staging, with the noise keyed on the 16 kHz source index).
// Bound at mfcc39_48k (batch 64 x 10 s int16, lengths 480,000 - 1,713*i):
//   bytes: 54.5 MB int16 in + 6.9 MB out -> ~18 us;
//   operations: 91 FLOP per output sample that holds signal (61 symmetric
//   taps folded) x ~9.1 M = 0.83 GFLOP, plus the front-end's 0.63 GFLOP
//   -> ~22 us: operations bound it (chip_smoke.py computes it per run).

// Dither (kDither; replaces _gather_frames' slab dither, frontend.py
// :537-546, and the hash of mfcc_tpu/ops/dither.py::dither_field :113-136).
// Every source sample 0 <= t < length (at 16 kHz: output positions in the
// fused form, masked at the output length) becomes
//   x[t] + sigma * noise(t),  noise(t) = BoxMuller16(fmix32(fmix32(
//       (t / S) * GOLDEN ^ seed') + t % S)),  seed' = fmix32(seed) (host)
// before pre-emphasis (mfcc_tpu_torch/ops/dither.py states the contract).
// The hash is native uint32; the uniforms (k + 0.5) * 2^-16 and the cos
// polynomial use __fmul_rn / __fadd_rn, so nvcc contracts none of them into
// an FMA and they stay bit-equal to the numpy contract; only logf and sqrtf
// may differ by ulps. The plain form stages x[t0-1 .. t0+span) into the
// signal row itself (x[t0 .. t0+span) in frame mode, where c = 0), the loads
// kStageBatch at a time as the dither-free staging issues them; a pass over
// the row then adds the noise in place at 0 <= t < length, so the hash runs
// once per staged sample, and pre-emphasis and zeroing follow in place a
// chunk at a time, each chunk read whole before it is written (the fused
// form's order, 1r). No second row is kept: kaldi_mfcc with dither takes
// 71,232 B, three blocks an SM, as without it. Centered framing hashes x[r]
// (and x[r-1] when c != 0) per staged sample.
// Cost per sample that holds signal: 30 float operations (uniforms 4, ln,
// -2x, sqrt, cos 20, r cos, sigma n, the add) and 25 integer ones (two
// fmix32, the row key, t / S and t % S, the 16-bit halves and their
// conversions).
//
// Frame-first conditioning (kCond; replaces _make_conditioning :620-655,
// _win_energy_np :244-251, and the staging without pre-emphasis of
// _gather_preemph :1643-1651): the staged signal is x zeroed at t >= length
// (the host passes preemph = 0 in "frame" mode), and per frame, in the
// warp that transforms it, over ALL of the frame's L samples f[n] (L may
// exceed N: the span stages all L, as the TPU kernel widens its chunk
// window, frontend.py:303-307, and only the first N are transformed):
//   mu   = sum f / L (remove_dc; else 0), a warp sum;
//   E    = sum (f - mu)^2 (raw_frame; a second pass over shared memory,
//          not sum f^2 - L mu^2, which cancels);
//   g[0] = (f0 - mu)(1 - c), g[n] = (fn - mu) - c (fn-1 - mu) (c = 0
//          outside "frame" mode), folded into the DFT's first loads, which
//          read fr[a] and fr[a-1] from the staged row;
//   E    = sum (w g)^2 (windowed_frame), from those loads and a pass over
//          the samples past N;
// and lane M holds max(E, eps) for the two frame energies.
//
// Valid frame counts and the frame mask (the reference's _stage_dict :1896;
// ops/chain.py num_valid_frames and frame_mask): every block computes its
// row's count from lengths[b] as given (in the fused resample from the
// output length ceil(lengths[b] up / down), in 64 bits), writes the mask of
// its own frames, and the row's first block writes n_valid[b]. So a card
// step launches no torch kernel for them. The count is integer arithmetic
// whose numerators are all made non-negative first, as the torch version's
// clamps and branches do, so C's truncating division equals its floor
// division.
//
// Epilogue log kinds (_make_epilogue :693-702), a warp-uniform switch:
//   ln: ln(where(m <= 0, eps, m)); ln_stab: ln(m + 1e-6);
//   db: 10 log10(where(m <= 0, eps, m)); ln_floor: ln(max(m, eps));
//   log10_floor: log10f(max(m, eps)) (CUDA's log10f, not ln times 1/ln 10).
//
// Bound of the new branches at kaldi_mfcc b64 x 10 s (F = 998, M = 23):
// conditioning adds 6L - 1 = 2,399 operations per frame (mean, centering,
// raw energy, frame pre-emphasis), 0.74 GFLOP in all -> 11.0 us; dither 55
// operations per sample that holds signal (the integer ones counted at the
// fp32 rate), +0.50 G -> 18.5 us. Both stay bound by operations; logmel80 at
// b256 is bound by its 83 MB of output (38 us). chip_smoke.py computes every
// bound from its run's inputs.
//
// Feature kinds (feature_kind, a warp-uniform switch in step 4 of every
// form; _make_epilogue :660-712):
//   logmel (mfcc and logmel configs): the log kind of the band sum, above.
//   plp (the PLP branch, :682-692): o[m] = the band sum, unlogged; lane M
//     the energy. ops/chain.py plp_base does the rest in tensor code.
//   spectrogram (the multi-tile output, :308-311): the identity projection,
//     o[m] = log kind of P[m] for m < M = N/2 + 1, lane M the energy, lane
//     m taking bins m, m + 32, ... No table is staged.
//   ssc (:965-975 and epilogue_ssc :673-677): per bin q[k] = P[k] <= 0 ?
//     eps : P[k], then o[m] = sum q[k] melf[k, m] / sum q[k] mel[k, m] over
//     the band (IEEE division), with melf[k, m] = f_k mel[k, m] rounded once
//     from float64 on the host and packed as mel is; both sums ride the same
//     lane split; o[M] = 0. P is indexed by bin here, so the TPU kernel's
//     per-lane clamp of eps / lanes_per_bin (a workaround for its scrambled
//     radix-4 lane order) is not needed.
// Bounds at b64 x 10 s int16 (chip_smoke.py computes them per run):
// kaldi_spectrogram is bound by bytes (20.5 MB in + 65.9 MB of
// [64, 998, 258] out: ~26 us); kaldi_plp (~11 us, kaldi_mfcc's operations
// less the logs) and ssc26 (~10 us: the clamps, two sums per weight and the
// divisions instead of the logs and the energy) by operations.
//
// The bf16x3 form (dft_form 1, kBf16x3; replaces the dft_passes="bf16x3"
// route of _make_kernel, :857-867, with the window-folded matrix of
// kernel_constants :160-241). An opt-in of its own accuracy class (~1e-4 on
// loud log-mel bins, as the reference's), chosen by the wrapper's dft_passes
// and not by n_fft; no config and no default path takes it. X = ah Wh +
// al Wh + ah Wl with fp32 accumulation: ah = rn(g) and al = rn(g - ah) of the
// conditioned, unwindowed samples (the window rides the matrix), the al Wl
// term (~2^-16 relative) dropped, as in the reference.
//   Block: 64 frames (kernels/frontend.py bf16_plan; 32, the wgmma's upper
//   rows zero, where 64 frames' power rows do not fit, as at n_fft 2048),
//   8 warps, one block an SM. Warps 0-3, one warpgroup, take 16 frames a
//   warp through wgmma.mma_async m64n136k16 bf16 (sm_90a) with A from
//   registers: each thread builds its fragment's hi and lo from the staged
//   fp32 signal and the frame's conditioning, so no A buffer exists.
//   B is the matrix, which the host lays out (bf16_matrix) in the ring's
//   order: [pass][k16 step][hi | lo][8-column group][K half][column][k],
//   K-major core matrices of 8 columns x 16 bytes read through wgmma's
//   no-swizzle descriptors (the two K halves 128 B apart, column groups
//   256 B apart; a core matrix is 128 contiguous bytes, so its rows take
//   distinct banks); column c of a pass is bin c/2's cosine (even c) or sine
//   (odd c), so re and im of a bin land in one thread's register pair and
//   |X|^2 forms in registers before one store to the power rows.
//   The matrix crosses L2 once a 64 frames (0.87 MB a block at classic13:
//   0.89 GB a b64 step, where the wmma form read ~3.6 GB): warp 4's lane 0
//   keeps a ring of 4 stages (3 or 2 where 4 do not fit) of 17,408-byte
//   chunks (one k16 step of 272 columns, hi and lo) full with cp.async.bulk
//   copies completing on full mbarriers, the first ones issued before the
//   staging; the consumers wait on a stage's full barrier, issue the six
//   products (three a column half of 136), wait for them and arrive on its
//   empty barrier. Two passes of 136 bins cover 257 (npass = 2).
//   A tile that stages nothing takes no product (its powers are 0).
//   Then step 4 as in every form over the power rows, stride bins rounded up
//   to 32 plus 4 (the fragment's 8 frames store to 8 bank groups).
// Shared memory at classic13 (floats): the span 63 S + L (42 KB), window,
// packed bands, the ring (4 x 17,408 B, 128-byte aligned), 2 x 4 mbarriers,
// power rows [64][292] (75 KB), frame energies and means, the per-warp
// scratch: 194,752 B; kernels/frontend.py smem_bytes mirrors it. A cluster
// of two blocks sharing each chunk by multicast was measured slower here
// (0.6793 vs 0.4378 ms, PERF.md section 6) and is not taken; the block plans share each
// chunk between two consumer warpgroups (128 frames) instead, and multicast
// is not measured for them.
// In the fused resample (kResample with kBf16) the staging is step 1r's at
// the plan's frames a block; the input window lies over the power rows, the
// energies, means and scratch, which stand idle until the products (not over
// the ring, whose first copies land during the staging), and the taps follow
// them. plan_bf16 counts both: mfcc39_48k takes 64 frames and 4 ring stages
// with int16 rows (195,008 B), 3 stages with float32 rows (226,496 B);
// mfcc39_44k 64 frames and 4 stages with int16 rows (231,232 B), 32 frames
// with float32 rows (192,912 B). Where no plan fits, the wrapper takes the
// split route with the plain form's bf16x3.
// Bound: the bytes and the function's minimum of the other forms (9.47 us at
// classic13 b64 x 10 s, by operations). The three passes alone are 3 x 2 x
// 400 x 514 = 1.23 MFLOP a frame: 0.0709 ms of bf16 tensor work at 989 TFLOP/s
// for 56,836 frames, 7.5x that minimum, so on Hopper the matrix DFT is no
// throughput route (the TPU's MXU made it one); its own roofline is that
// 0.0709 ms.
//
// The bf16x3 form's block plans (kBf16 with kBlock, logmel_kernel_bf16,
// step 3b; plan_bf16 walks kBfLadder after "staged", 128 frames a block;
// kernels/frontend.py bf16_layout mirrors it; the plain form only, so
// a resampling config whose fused layout is over the block takes the split
// route). "staged" holds the span (63 S + L), the window (max(L, n_fft)),
// the packed bands and power rows of every bin (64 x 2,084 floats at n_fft
// 4,096): from n_fft 2,245 at classic13, at hops of ~0.07 s and frames of
// ~1 s it is over the block. The reference's route has no such limit.
//   What bounds them: the products, 3 x 2 kp x 2 nbp flops a frame (0.57 ms
//   at classic13 n_fft 4,096 b64 at the bf16 peak), and the matrix, 8 kp nbp
//   bytes read whole by each tile (6.96 MB at n_fft 4,096, from L2; 276 MB
//   at librosa's 8,192-point framing, from HBM), and at thousands of filters
//   the projection and the [B, F, M + 1] output. The first design of these
//   plans (one consumer warpgroup, its A fragment rebuilt from the frame
//   each step of each pass, each step's products waited for before the
//   next, the projection by the same warps between passes) took 4.12 ms
//   there: 1.39 ms of it the A build, 2.06 the products' waits, 0.64 the
//   projection, 0.15 the ring (PERF.md section 6, the breakdown).
//   The design: 384 threads, one block an SM. (1) A once a tile: every
//   thread builds the tile's A, bf16 hi and lo of each frame's conditioned
//   samples (staged_at from device memory, the mean first: no span, no
//   window staged), in wgmma's K-major core matrices step by step ([hi |
//   lo][8-frame group][K half][frame][k]; 64 bytes a frame a step), into
//   shared memory ("pass", where tile x kp x 4 bytes fit: short frames) or
//   the tile's rows of a workspace (gather and after; kp = 400 at 128 frames
//   is 200 KB), whence warp 8's lane 0 streams each step's A through the
//   ring beside the matrix chunk (tile x 64 bytes more a stage); staged_at
//   runs twice a sample a tile (the mean, then A), not once a pass. (2) Two
//   consumer warpgroups (warps 0-7) take each chunk together, 64 frames each
//   over the pass's 272 columns, so each chunk read from L2 or HBM serves
//   128 frames (64 frames a block, both warpgroups on them a column half
//   each with A in shared memory, took 1.47x as long at n_fft 4,096 in
//   turns, PERF.md section 6). A and B come from shared memory through
//   descriptors; each
//   step's group of products stays in flight while the next one is waited
//   for and issued (wait_group 1), and a stage is released once the group
//   that read it has retired. (3) The projectors (warps 9-11) project pass
//   p from the power rows (one buffer, stride 137) while the consumers run
//   pass p + 1, items claimed a warp at a time from a counter; the
//   consumers, at their next handoff (the pass's end, or its first
//   promotion where a pass takes more than kBfPromote steps and the power
//   rows hold its re/im), take what is left of it, then the power rows turn
//   over (named barriers: full, empty); the last pass and the epilogue are
//   the consumers' and projectors' together. Where the accumulators are in
//   the workspace, a warp's items run along a frame's row, and at
//   thousands of filters a warp takes 32 segments over every frame (the
//   pass table read once a tile, its adds and stores coalesced); a filter's last
//   piece writes its output lane (the epilogue writes the energy alone),
//   its first one its accumulator (nothing is zeroed). (4) The promotion is kept: the
//   tensor cores sum kBfPromote (25) steps, then the stretch joins the
//   pass's re/im rows in fp32 (2.5e-6 of drift at L = n_fft = 8,192).
//   The arithmetic is the first design's: the same products in the same
//   order, each projection segment summed in packed order and the pieces
//   added in pass order (tests/test_torch_bf16x3_plans.py
//   _emulate_block_plan), so results do not depend on a row's place in the
//   batch. A tile with no frame that holds samples takes no product (zero
//   powers, projected as any). setmaxnreg moves registers to the consumers
//   (216 a thread; the projectors and the producer 72), so the consumers
//   hold their 136 accumulators while they take a share of the projection.
// The matrix is the route's only limit left: the wrapper refuses a matrix,
// or the host's float64 folding of it, over the card's memory
// (kernels/frontend.py bf16_matrix_reason) before building it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "polyphase.cuh"

// A named namespace, not an anonymous one: the build compiles this file
// once for each part of its instantiations (FRONTEND_PART, below) and links
// the objects into one library, so the parts share these types by name.
namespace mfcc_frontend {

namespace cg = cooperative_groups;

constexpr int kTile = 32;  // frames per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFftBlocks = 3;   // blocks an SM the FFT forms are built for
constexpr int kStageBatch = 8;  // samples a thread loads at once while staging
constexpr int kProjBatch = 4;   // packed weights a lane loads at once in the projection
constexpr int kMaxStages = 16;  // Stockham stages, 4 bits each in Params::radices
constexpr int kSmemBudget = 232448;  // the H100's dynamic shared memory a block
// The bf16x3 form: a wgmma step's K, the bins of a pass (two m64n136k16
// products over 272 interleaved cosine and sine columns), the bytes of one
// part (hi or lo) of a step and of a ring stage (hi and lo), the ring's
// deepest plan, and the consumer warpgroup (warps 0-3) and the thread
// that issues the ring's copies (warp 4, lane 0).
constexpr int kBfStep = 16;
constexpr int kBfPassBins = 136;
constexpr int kBfGroups = 2 * kBfPassBins / 8;               // 8-column groups a pass
constexpr int kBfPartBytes = kBfStep * 2 * kBfPassBins * 2;  // 8,704
constexpr int kBfStageBytes = 2 * kBfPartBytes;              // 17,408
constexpr int kBfMaxStages = 4;
constexpr int kConsumers = 128;
constexpr int kProducer = 128;
// The bf16x3 block plans (logmel_kernel_bf16): steps whose products the
// tensor cores sum before the sum joins the pass's re/im rows in fp32; the
// floats between two frames' re/im rows (272 columns; 280 = 24 mod 32: a
// quarter warp's float2 accesses take 32 distinct banks) and between two
// frames' power rows (137, odd: 32 frames of a projection item fall in 32
// banks); the bytes of one frame's A in one step (hi and lo of 16 samples);
// the frames a block (two consumer warpgroups of 64); the threads: the two
// consumer warpgroups (warps 0-7), then warp 8, whose lane 0 issues the
// ring's copies, and the projectors (warps 9-11); the registers setmaxnreg
// gives a consumer thread and the others (2 x 216 + 72 = 504 a thread of
// each warpgroup: at 224 and 64, the whole register file, one consumer
// warpgroup never got its registers); the named barriers: the consumers',
// the power rows full and empty, and the end of the last projection.
constexpr int kBfPromote = 25;
constexpr int kBfAccStride = 2 * kBfPassBins + 8;
constexpr int kBfPowStride = kBfPassBins + 1;
constexpr int kBfAChunk = 2 * kBfStep * 2;
constexpr int kBfTile = 128;
constexpr int kBfThreads = 384;
constexpr int kBfConsumers = 256;
constexpr int kBfProducer = 256;
constexpr int kBfProjectors = 96;
constexpr int kBfTeam = kBfConsumers + kBfProjectors;  // consumers and projectors
constexpr int kBfConsumerRegs = 216;
constexpr int kBfOtherRegs = 72;
constexpr int kBfItems = 4;  // projection items a thread claims at once
enum { kBarConsumers = 1, kBarFull = 2, kBarEmpty = 3, kBarEnd = 4 };
// The cluster plan's largest portable cluster (blocks a frame).
constexpr int kMaxCluster = 8;
// The wide plan's projection: filters a thread takes at once, a chunk's
// (kWideFilters a thread of the block), and the tiles (frames a block) from
// which it takes them a chunk at a time (kernels/frontend.py wide_tile: the
// large FFTs' shorter tiles take them a filter at a time).
constexpr int kWideFilters = 8;
constexpr int kWideChunk = kWideFilters * kThreads;
constexpr int kWideChunkTile = 16;

// energy_source, log_kind, feature_kind, DFT form, reflection and framing
// codes (kernels/frontend.py ENERGY_SOURCES, ops/chain.py LOG_KINDS,
// kernels/frontend.py FEATURE_KINDS, DFT_FORMS, CENTER_CODES, FRAMINGS)
enum { kPspec = 0, kRawFrame = 1, kWindowedFrame = 2 };
enum { kLn = 0, kLnStab = 1, kDb = 2, kLnFloor = 3, kLog10Floor = 4 };
enum { kLogmel = 0, kPlp = 1, kSpectrogram = 2, kSsc = 3 };
enum { kStockham = 0, kBf16x3 = 1, kBluestein = 2 };
enum { kNoCenter = 0, kCenter = 1, kCenterReflect = 2 };
enum { kFramePad = 0, kFrameDrop = 1, kFrameCenter = 2, kFrameCenterReflect = 3 };  // FRAMINGS

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int align32(int n) { return (n + 31) & ~31; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Per-config scalars of one launch.
struct Params {
  int T, F, L, S, M;
  // packed mel weights (kernels/frontend.py mel_packed)
  int nnz;
  // DFT size and form; frame 0's first sample (0, S/2 - L/2 or -(L/2)) and
  // the reflection kind of centered framing
  int n_fft, form, offset, center;
  float scale, preemph, eps, pscale;
  // dither (kDither): sigma and the host-premixed seed fmix32(seed)
  float dither;
  uint32_t seed;
  // conditioning (kCond); frame_keep0 = 1 - frame_preemph, rounded on the host
  int remove_dc, energy_source, log_kind;
  float frame_preemph, frame_keep0;
  int feature_kind;
  // the frame counts' framing code and drop_last_frame
  int framing, drop_last;
  // derived on the host (plan()): half = n_fft / 2, bins = n_fft / 2 + 1;
  // block (the block plan), its groups (frames a block transforms at
  // once, 4, 2 or 1, each by 256 / groups threads), tables_global (its
  // tables read from device memory, not staged), gather (the gather
  // plan: no span and no window staged, each frame read from device
  // memory), bands_global (the packed mel bands read from device memory,
  // not staged) and rows_global (each group's two FFT rows in a slot of
  // the workspace in device memory: a persistent grid of nslots blocks,
  // block i in slot i, looping over the tiles of the batch's rows) and
  // sums_global (the projection's filter sums in device memory too: the
  // output row, and for SSC the melf sums in the slot); bchunk, the
  // weights a thread of a group sums;
  // fft_n, the points of the form's Stockham FFT (half, or the Bluestein
  // form's P), its radices, stage s in bits [4s, 4s + 4); the twiddle and
  // output-base table lengths; the projection's weights a lane. The
  // twiddle table holds the real split's nsplit entries, the stages'
  // twists, and for the Bluestein form the chirp (bq entries from `chirp`)
  // and the filter spectrum (nfilt from `filt`); bq points in, bk outputs.
  // For the bf16x3 form: the matrix depth kp = min(L, n_fft) rounded up to
  // 16, bins nbp = 136 npass, the power rows' stride pws, frames a block
  // (tile) and ring stages; in its block plans (block: the power rows of one
  // pass; gather and bands_global as above, the packed bands and the pass
  // table from device memory; acc_global, the accumulators in the workspace)
  // the accumulators a frame (nacc) and the pass table's words (nptab, an
  // upper bound: npass + 1 offsets and 4 words a segment).
  int half, bins, fft_n, nstages;
  unsigned long long radices;
  int block, groups, tables_global, gather, bands_global, rows_global, sums_global, nslots, batch;
  int ntw, nbases, chunk, bchunk, nsplit, bq, bk, chirp, filt, nfilt;
  int kp, nbp, npass, pws, tile, stages, nacc, nptab, acc_global;
  // the fused resample: the rows' base pointer is 16-byte aligned (vector loads)
  int aligned;
  // the block launch (streaming): 1 when each row's sample 0 is the
  // pre-context x[-1] and frame 0 starts at sample 1, else 0
  int origin;
  // the cluster plan (cluster = C blocks a frame, else 0): its local FFT of
  // cl_n = fft_n / C points (nstages, radices, ntw and nbases are then the
  // local FFT's), the exchange's cl_j = cl_n / C butterflies a rank, the
  // power bins a rank cl_pb = ceil(bins / C), and the offset of the
  // exchange's twists in the twiddle table
  int cluster, cl_n, cl_j, cl_pb, cross;
  // the wide plan (1, else 0): tile frames a block, groups frames at once
  // in its FFT stage, pws the power rows' stride
  int wide;
};

// Packed weight tables staged for the feature kind: mel; none for the
// spectrogram's identity; mel and melf for ssc.
__host__ __device__ inline int weight_tables(const Params& p) {
  return p.feature_kind == kSpectrogram ? 0 : p.feature_kind == kSsc ? 2 : 1;
}

// Dynamic shared memory layout, in floats (every offset 16-byte aligned;
// the header states it, kernels/frontend.py smem_bytes mirrors it). part is
// warp 0's projection scratch (32 lane partials and the M filter sums, for
// each weight table), pstride the step to the next warp's; in the block
// plan each group's (256 / groups partials and M sums a table; the partials
// alone where the sums are in device memory, sums_global), then red, the 8
// warps' partials of a block sum.
struct Layout {
  int span, win, melw, melf, moff, meta, tw, bases, buf, row, part, pstride, red, bar, pw, ef, mu, fir,
      tab, total;
};

// fir is the fused resample's input window in floats (0 without it): it
// lies over the warps' rows (the bf16x3 form: over the power rows, the
// frames' energies and means and the projection's scratch), which stand
// idle until the DFT, and widens them only where it is longer. wide (the
// fused resample, and kDither) gives the signal row span + 1 floats:
// x[t0-1 .. t0+span) before pre-emphasis. The gather plan stages no signal
// row and no window: its layout starts at the packed bands, or, with the
// bands in device memory (bands_global), at the tables. With the rows in
// device memory (rows_global) l.row is the workspace's row, and the
// layout holds only the groups' scratch and the warps' partials (with the
// sums in device memory too, sums_global, the partials alone). block is
// p.block, which the kernel passes as its template's kBlock, so an
// instantiation computes no other layout. The bf16x3 form's block plans
// have a layout of their own (bf16_block_layout).
__host__ __device__ inline Layout layout(const Params& p, int fir, int taps, bool wide, bool block) {
  Layout l;
  const int tables = weight_tables(p);
  const int staged = p.bands_global ? 0 : tables;  // packed weight tables staged
  const int parts = align4(tables * (32 + p.M));
  l.span = p.gather ? 0 : (p.tile - 1) * p.S + p.L;
  l.win = p.gather ? 0 : align4(l.span + (wide ? 1 : 0));
  l.melw = l.win + (p.gather ? 0 : align4(imax(p.L, p.n_fft)));
  l.melf = l.melw + align4(p.nnz);  // ssc only
  l.moff = l.melw + staged * align4(p.nnz);
  l.meta = l.moff + (staged ? align4(p.M + 1) : 0);
  l.tw = l.meta + (staged ? align4(p.nnz) : 0);
  l.bases = l.tw + align4(2 * p.ntw);
  l.buf = l.bases + align4(p.nbases);
  l.red = 0;
  if (p.form == kBf16x3) {
    // the ring, 128-byte aligned for its bulk copies
    l.buf = align32(l.buf);
    l.row = 0;
    l.bar = l.buf + p.stages * (kBfStageBytes / 4);
    l.pw = l.bar + align4(4 * p.stages);  // full and empty mbarriers, 8 B each
    l.ef = l.pw + p.tile * p.pws;
    l.mu = l.ef + align4(p.tile);
    l.part = l.mu + align4(p.tile);
    l.pstride = parts;
    l.fir = l.pw;  // not the ring: its first copies land during the staging
    l.tab = l.pw + imax(l.part + kWarps * parts - l.pw, align4(fir));
  } else if (block) {
    if (p.tables_global) l.buf = l.tw;  // no table staged
    l.row = align4(2 * (p.fft_n + (p.fft_n >> 3) + 1));
    l.part = l.buf + (p.rows_global ? 0 : p.groups * 2 * l.row);
    l.pstride = align4(tables * (kThreads / p.groups + (p.sums_global ? 0 : p.M)));
    l.red = l.part + p.groups * l.pstride;
    l.bar = l.pw = l.ef = l.mu = 0;
    l.fir = l.buf;
    l.tab = l.buf + imax(l.red + kWarps - l.buf, align4(fir));
  } else {
    l.row = align4(2 * (p.fft_n + (p.fft_n >> 3) + 1));
    l.part = l.buf + 2 * l.row;
    l.pstride = 2 * l.row + parts;
    l.bar = l.pw = l.ef = l.mu = 0;
    l.fir = l.buf;
    l.tab = l.buf + imax(kWarps * l.pstride, align4(fir));
  }
  l.total = l.tab + align4(taps);
  return l;
}

// The bf16x3 form's block plans' layout (logmel_kernel_bf16), in floats
// (kernels/frontend.py _bf16_smem mirrors it): the packed weights (and
// SSC's melf weights), the filters' offsets and the pass table, unless
// bands_global; at a
// 128-byte boundary the ring, each stage a matrix chunk and, where A is
// in the workspace (gather), the tile's A of that step; its full and empty
// mbarriers and the projection's claim counter; at a 128-byte boundary
// the tile's A ("pass": in shared
// memory); one pass's power rows (stride kBfPowStride), or, where a pass
// takes more than kBfPromote steps, its re/im rows (stride kBfAccStride),
// which then take its powers; the frames' energies and means; the
// accumulators unless acc_global. No signal span, window or bin table.
struct BfLayout {
  int w, wf, moff, ptab, ring, stage, bar, a, pw, ef, mu, acc, total;
};

__host__ __device__ inline BfLayout bf16_block_layout(const Params& p) {
  BfLayout l;
  const int staged = p.bands_global ? 0 : weight_tables(p);
  l.w = 0;
  l.wf = align4(p.nnz);  // ssc only
  l.moff = staged * align4(p.nnz);
  l.ptab = l.moff + (staged ? align4(p.M + 1) : 0);
  l.ring = align32(l.ptab + (staged ? align4(p.nptab) : 0));
  l.stage = (kBfStageBytes + (p.gather ? p.tile * kBfAChunk : 0)) / 4;
  l.bar = l.ring + p.stages * l.stage;
  l.a = align32(l.bar + 4 * p.stages + 4);  // the projection's claim counter after the mbarriers
  l.pw = l.a + (p.gather ? 0 : p.tile * p.kp);
  l.ef = l.pw + p.tile * (p.kp / kBfStep > kBfPromote ? kBfAccStride : kBfPowStride);
  l.mu = l.ef + p.tile;
  l.acc = l.mu + p.tile;
  l.total = l.acc + (p.acc_global ? 0 : align4(p.tile * p.nacc));
  return l;
}

// Floats of the bf16x3 block plans' workspace (kernels/frontend.py
// bf16_workspace): the accumulators [B, F, nacc] (acc_global), rounded up
// to 128 bytes, then each tile's A, step by step (gather), tile x kp floats
// a tile; 0 for neither.
__host__ __device__ inline long long bf16_workspace(const Params& p, int B) {
  if (p.form != kBf16x3 || !p.block) return 0;
  const long long acc = p.acc_global ? (static_cast<long long>(B) * p.F * p.nacc + 31) / 32 * 32 : 0;
  const long long tiles = static_cast<long long>(B) * ((p.F + p.tile - 1) / p.tile);
  return acc + (p.gather ? tiles * p.tile * p.kp : 0);
}

// The cluster plan's layout a block, in floats (kernels/frontend.py
// cluster_smem mirrors it): the rank's two rows of its cl_n points (padded
// as every plan's rows), the projection's thread partials and filter
// partials (M, twice for ssc, none for a spectrogram), the 8 warps'
// partials, 4 slots of the rank's sums (the power sum, the frame energy,
// the mean's sum) and the ranks' filter ranges (2 ints a rank).
struct ClusterLayout {
  int row, part, sum, red, slot, rng, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(const Params& p) {
  ClusterLayout l;
  const int tables = weight_tables(p);
  l.row = align4(2 * (p.cl_n + (p.cl_n >> 3) + 1));
  l.part = 2 * l.row;
  l.sum = l.part + tables * kThreads;
  l.red = l.sum + align4(tables * p.M);
  l.slot = l.red + kWarps;
  l.rng = l.slot + 4;
  l.total = l.rng + 2 * kMaxCluster;
  return l;
}

// The wide plan's layout a block, in floats (kernels/frontend.py wide_smem
// mirrors it): each group's two FFT rows (padded as every plan's), then the
// tile's p.tile power rows (stride p.pws = bins rounded up to 4), the frames'
// energy lanes and the 8 warps' partials of a group sum.
struct WideLayout {
  int row, pw, en, red, total;
};

__host__ __device__ inline WideLayout wide_layout(const Params& p) {
  WideLayout l;
  l.row = align4(2 * (p.fft_n + (p.fft_n >> 3) + 1));
  l.pw = p.groups * 2 * l.row;
  l.en = l.pw + p.tile * p.pws;
  l.red = l.en + align4(p.tile);
  l.total = l.red + kWarps;
  return l;
}

// The fused resample's input window for x[t0-1 .. t0+span) of a block's
// p.tile frames: samples, and floats of Sample.
__host__ __device__ inline int resample_window(const Params& p, const Polyphase& pp) {
  return pp_window((p.tile - 1) * p.S + p.L + 1, pp);
}
template <typename Sample>
__host__ __device__ inline int resample_floats(const Params& p, const Polyphase& pp) {
  return pp_stage_floats<Sample>(resample_window(p, pp));
}

// The bf16x3 form's block plans after "staged" (kernels/frontend.py
// BF16_PLANS and BF16_TRAITS): whether a plan keeps the tile's A in the
// workspace and streams it through the ring (gather; else A in shared
// memory), reads the packed bands and the pass table from device memory
// (bands_global) and keeps its accumulators in the workspace (acc_global).
constexpr int kBfLadder[4][3] = {
    {0, 0, 0},  // pass
    {1, 0, 0},  // gather
    {1, 1, 0},  // gather_bands
    {1, 1, 1},  // gather_out
};

// The bf16x3 form's shape (kernels/frontend.py bf16_dims, bf16_layout): the
// matrix depth kp, whole passes of 136 bins; then the first layout that
// fits the block's shared memory: the staged plan at 64 or 32 frames and
// 4, 3 or 2 ring stages (power rows of every bin); then, in the plain form
// (pp null), the block plans (p.block) at 128 frames: the rungs of
// kBfLadder in turn, 4, 3 or 2 stages ("gather_out" at 2 stages, 196 KB at
// most, always fits). The fused
// resample (pp not null, with the input window of that many frames in the
// rows' type and the taps) takes the staged plan alone: the wrapper takes
// the split route where it does not fit.
inline bool plan_bf16(Params& p, const Polyphase* pp, bool int16) {
  p.kp = (imin(p.L, p.n_fft) + kBfStep - 1) / kBfStep * kBfStep;
  p.npass = (p.bins + kBfPassBins - 1) / kBfPassBins;
  p.nbp = p.npass * kBfPassBins;
  p.pws = (p.bins + 31) / 32 * 32 + 4;
  p.nacc = p.feature_kind == kSsc ? 2 * p.M : p.feature_kind == kSpectrogram ? 1 : p.M + 1;
  p.nptab = weight_tables(p) ? p.npass + 1 + 4 * (p.nnz / kBfPassBins + 2 * p.M) : 0;
  auto fits = [&](int tile, int stages) {
    p.tile = tile;
    p.stages = stages;
    if (p.block) return bf16_block_layout(p).total * 4 <= kSmemBudget;
    int fir = 0, taps = 0;
    if (pp) {
      fir = int16 ? resample_floats<int16_t>(p, *pp) : resample_floats<float>(p, *pp);
      taps = pp->up * pp_stride(*pp);
    }
    return layout(p, fir, taps, pp || p.dither > 0.f, false).total * 4 <= kSmemBudget;
  };
  const int tiles[2] = {64, 32};
  for (int tile : tiles) {
    for (int stages = kBfMaxStages; stages >= 2; --stages) {
      if (fits(tile, stages)) return true;
    }
  }
  if (pp) return true;
  p.block = 1;
  for (const auto& rung : kBfLadder) {
    p.gather = rung[0];
    p.bands_global = rung[1];
    p.acc_global = rung[2];
    for (int stages = kBfMaxStages; stages >= 2; --stages) {
      if (fits(kBfTile, stages)) return true;
    }
  }
  return true;
}

__device__ inline float to_f32(int16_t v) { return static_cast<float>(v); }
__device__ inline float to_f32(float v) { return v; }

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// murmur3 fmix32
__device__ inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// cos(2 pi u), u in (0, 1), from exact float ops in the contract's order
// (ops/dither.py _cos2pi): quarter-period reduction, then Horner in b^2 on
// the float32 Taylor coefficients _C2PI (hex literals, held against the
// Python table by tests/test_torch_dither.py).
__device__ inline float cos2pi(float u) {
  const float a = __fsub_rn(u, floorf(__fadd_rn(u, 0.5f)));
  const float aa = fabsf(a);
  const bool flip = aa > 0.25f;
  const float b = flip ? __fsub_rn(0.5f, aa) : aa;
  const float t = __fmul_rn(b, b);
  float acc = 0x1.f9d38ap+2f;                         // C2PI[6]
  acc = __fadd_rn(__fmul_rn(acc, t), -0x1.a6d1f2p+4f);  // C2PI[5]
  acc = __fadd_rn(__fmul_rn(acc, t), 0x1.e1f506p+5f);   // C2PI[4]
  acc = __fadd_rn(__fmul_rn(acc, t), -0x1.55d3c8p+6f);  // C2PI[3]
  acc = __fadd_rn(__fmul_rn(acc, t), 0x1.03c1f0p+6f);   // C2PI[2]
  acc = __fadd_rn(__fmul_rn(acc, t), -0x1.3bd3ccp+4f);  // C2PI[1]
  acc = __fadd_rn(__fmul_rn(acc, t), 0x1p+0f);          // C2PI[0]
  return flip ? -acc : acc;
}

// x + sigma * noise(t): the dither contract at signal position 0 <= t < 2^32.
__device__ inline float dithered(float x, uint32_t t, const Params& p) {
  const uint32_t row = t / static_cast<uint32_t>(p.S);
  const uint32_t lane = t - row * static_cast<uint32_t>(p.S);
  const uint32_t h = fmix32(fmix32((row * 0x9E3779B9u) ^ p.seed) + lane);
  const float k = 1.f / 65536.f;
  const float u1 = __fmul_rn(__fadd_rn(static_cast<float>(h >> 16), 0.5f), k);
  const float u2 = __fmul_rn(__fadd_rn(static_cast<float>(h & 0xFFFFu), 0.5f), k);
  const float n = __fmul_rn(sqrtf(__fmul_rn(-2.f, logf(u1))), cos2pi(u2));
  return __fadd_rn(x, __fmul_rn(p.dither, n));
}

// The source sample x[t] (0 <= t < length): converted, scaled, and under
// kDither plus the contract noise keyed on t.
template <bool kDither, typename Sample>
__device__ inline float source(const Sample* row, long long t, const Params& p) {
  const float x = to_f32(row[t]) * p.scale;
  if constexpr (kDither) return dithered(x, static_cast<uint32_t>(t), p);
  return x;
}

// ops/chain.py reflect_index: t -> [0, n), n >= 1. "center" repeats the
// edge sample (period 2n), "center_reflect" does not (period 2(n-1), 1 at
// n = 1). Indices inside the row map to themselves without a division.
__device__ inline long long reflect(long long t, long long n, int kind) {
  if (t >= 0 && t < n) return t;
  const long long per = kind == kCenter ? 2 * n : (n > 1 ? 2 * n - 2 : 1);
  long long m = t % per;
  if (m < 0) m += per;
  if (m < n) return m;
  return kind == kCenter ? 2 * n - 1 - m : 2 * n - 2 - m;
}

// The gather plan's sample (step 2g): what the plain form's staged span
// holds at frame position t = f S + a of a row of len samples, computed from
// device memory by the arithmetic of the staging that span takes (step 1c
// for centered framing, 1d under kDither, 1 otherwise), so the two plans
// frame the same values.
template <bool kDither, typename Sample>
__device__ inline float staged_at(const Sample* row, long long t, long long len, const Params& p) {
  const float c = p.preemph;
  if (p.center != kNoCenter) {  // 1c: the reflected source index r
    const long long r = reflect(t + p.offset, len > 0 ? len : 1, p.center);
    const bool in = r < len;
    const float x = in ? source<kDither>(row, r, p) : 0.f;
    const float xp = in && c != 0.f && r > 0 ? source<kDither>(row, r - 1, p) : 0.f;
    return c != 0.f ? x - c * xp : x;
  }
  if (t >= len) return 0.f;  // zeroing after pre-emphasis
  if constexpr (kDither) {  // 1d: the noise on x[t] and x[t-1] before pre-emphasis
    const float x = dithered(source<false>(row, t, p), static_cast<uint32_t>(t), p);
    if (c == 0.f) return x;
    const float xp = t > 0 ? dithered(source<false>(row, t - 1, p), static_cast<uint32_t>(t - 1), p) : 0.f;
    return x - c * xp;
  }
  const float x = source<false>(row, t, p);
  const float xp = t + p.origin > 0 ? source<false>(row, t - 1, p) : 0.f;
  return x - c * xp;
}

// ops/chain.py num_valid_frames for a row of n samples at the frame rate:
// 1 + ceil(max(0, n - L) / S) ("pad"), 1 + (n - L) / S for n >= L else 0
// ("drop"), (n + S/2) / S ("center"), 1 + (n + 2 (L/2) - L) / S
// ("center_reflect"), one fewer under drop_last_frame (not below 0), and 0
// for n <= 0. Every numerator is non-negative where it is divided, so C's
// truncation is the floor division of the torch version; 64-bit throughout.
__device__ inline int valid_frames(long long n, const Params& p) {
  if (n <= 0) return 0;
  const long long L = p.L, S = p.S;
  long long v;
  switch (p.framing) {
    case kFrameDrop:
      v = n >= L ? 1 + (n - L) / S : 0;
      break;
    case kFrameCenter:
      v = (n + S / 2) / S;
      break;
    case kFrameCenterReflect:
      v = 1 + (n + 2 * (L / 2) - L) / S;  // n >= 1: the numerator is >= 0
      break;
    default:
      v = 1 + ((n > L ? n - L : 0) + S - 1) / S;
  }
  if (p.drop_last) v = v > 0 ? v - 1 : 0;
  return static_cast<int>(v);
}

__device__ inline float log_lane(float m, const Params& p) {
  switch (p.log_kind) {
    case kLnStab: return logf(m + 1e-6f);
    case kDb: return 10.f * log10f(m <= 0.f ? p.eps : m);
    case kLnFloor: return logf(fmaxf(m, p.eps));
    case kLog10Floor: return log10f(fmaxf(m, p.eps));
    default: return logf(m <= 0.f ? p.eps : m);
  }
}

__device__ inline float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__device__ inline float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ inline float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// A Stockham row's index i lives at i + i/8: one float2 of padding after
// every 8, so stride-8 stores spread over the banks.
__device__ inline int pad(int i) { return i + (i >> 3); }

// A load from a table: a plain load (staged in shared memory, or where the
// pointer chosen once a block is in device memory), or (kG, "gather_rows")
// from device memory through the read-only path.
template <bool kG, typename T>
__device__ inline T ld(const T* p) {
  if constexpr (kG) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// bar.sync on barrier id (1-15; 0 is __syncthreads') by n threads, whole
// warps.
__device__ inline void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// bar.arrive: counts this warp towards barrier id's n threads, without
// waiting (the threads that wait take bar.sync)
__device__ inline void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The threads that transform one frame: in the warp plan a warp (rank the
// lane); in the block plan a group of the block (all 256 threads, or 128 or
// 64 where the block takes 2 or 4 frames at once) meeting at its named
// barrier; kGlobal: "gather_rows" (its rows in the workspace, its tables by
// __ldg from device memory).
struct WarpTeam {
  static constexpr bool kGlobal = false;
  int rank;
  __host__ __device__ static constexpr int size() { return 32; }
  __device__ void sync() const { __syncwarp(); }
};
template <bool kGlobal_>
struct GroupTeam {
  static constexpr bool kGlobal = kGlobal_;
  int rank, n, id;
  __device__ int size() const { return n; }
  __device__ void sync() const { named_sync(id, n); }
};

// The group's sum of v (every thread of the group calls it): each warp's
// shuffle sum, then the group's warps' partials in order from red (a float a
// warp of the block), so two runs give the same bits.
template <typename T>
__device__ inline float group_sum(float v, float* red, const T& team) {
  const int warp = threadIdx.x >> 5, w0 = warp - (team.rank >> 5);
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  team.sync();
  float s = red[w0];
  for (int w = 1; w < team.size() / 32; ++w) s += red[w0 + w];
  team.sync();  // red is rewritten by the next sum
  return s;
}

// R-point forward DFTs, X[q] = sum_r v[r] e^{-2 pi i r q / R}, in place.
// Constants are float64 values rounded once to float32 (no sincosf).
template <int R>
__device__ inline void dft_small(float2 (&v)[R]);

template <>
__device__ inline void dft_small<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <>
__device__ inline void dft_small<3>(float2 (&v)[3]) {
  const float s = 0x1.bb67aep-1f;  // sin(2 pi / 3)
  const float2 t1 = cadd(v[1], v[2]);
  const float2 t2 = csub(v[1], v[2]);
  const float2 a = make_float2(v[0].x - 0.5f * t1.x, v[0].y - 0.5f * t1.y);
  v[0] = cadd(v[0], t1);
  v[1] = make_float2(a.x + s * t2.y, a.y - s * t2.x);  // a - i s t2
  v[2] = make_float2(a.x - s * t2.y, a.y + s * t2.x);  // a + i s t2
}

template <>
__device__ inline void dft_small<4>(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]);
  const float2 a1 = csub(v[0], v[2]);
  const float2 b0 = cadd(v[1], v[3]);
  const float2 b1 = csub(v[1], v[3]);
  v[0] = cadd(a0, b0);
  v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
  v[2] = csub(a0, b0);
  v[3] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
}

template <>
__device__ inline void dft_small<5>(float2 (&v)[5]) {
  const float c1 = 0x1.3c6ef4p-2f;   // cos(2 pi / 5)
  const float c2 = -0x1.9e377ap-1f;  // cos(4 pi / 5)
  const float s1 = 0x1.e6f0e2p-1f;   // sin(2 pi / 5)
  const float s2 = 0x1.2cf230p-1f;   // sin(4 pi / 5)
  const float2 t1 = cadd(v[1], v[4]);
  const float2 t2 = cadd(v[2], v[3]);
  const float2 t3 = csub(v[1], v[4]);
  const float2 t4 = csub(v[2], v[3]);
  const float2 a1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
  const float2 b1 = make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y);
  const float2 b2 = make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y);
  v[0] = make_float2(v[0].x + t1.x + t2.x, v[0].y + t1.y + t2.y);
  v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
  v[4] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
  v[2] = make_float2(a2.x + b2.y, a2.y - b2.x);  // a2 - i b2
  v[3] = make_float2(a2.x - b2.y, a2.y + b2.x);  // a2 + i b2
}

// Radix 8 as two radix-4 DFTs of the even and odd inputs, then
// X[q] = E[q] + W8^q O[q] and X[q + 4] = E[q] - W8^q O[q], W8 = e^{-i pi/4}.
template <>
__device__ inline void dft_small<8>(float2 (&v)[8]) {
  const float h = 0x1.6a09e6p-1f;  // sqrt(2) / 2
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft_small<4>(e);
  dft_small<4>(o);
  const float2 t1 = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));   // (1 - i) h o1
  const float2 t2 = make_float2(o[2].y, -o[2].x);                                // -i o2
  const float2 t3 = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));  // -(1 + i) h o3
  v[0] = cadd(e[0], o[0]);
  v[4] = csub(e[0], o[0]);
  v[1] = cadd(e[1], t1);
  v[5] = csub(e[1], t1);
  v[2] = cadd(e[2], t2);
  v[6] = csub(e[2], t2);
  v[3] = cadd(e[3], t3);
  v[7] = csub(e[3], t3);
}

// One Stockham stage of radix R over H points after ns = the product of the
// earlier radices: butterfly j < H/R (the team's thread rank, rank +
// size, ...) loads inputs j + r H/R (stage 0 by first(n), from the staged
// signal; later stages from the padded row src), twists input r by
// tw[j (R-1) + r - 1] = e^{-2 pi i r k/(ns R)}, k = j mod ns (none at ns = 1:
// every twist is 1), and stores output r at base[j] + r ns = (j - k) R + k +
// r ns into the padded row dst. kG: the tables in device memory.
template <int R, bool kFirst, typename T, typename First>
__device__ inline void stockham_stage(First first, const float2* __restrict__ src,
                                      float2* __restrict__ dst, int H, int ns,
                                      const float2* __restrict__ tw,
                                      const int* __restrict__ base, const T& team) {
  constexpr bool kG = T::kGlobal;
  const int hr = H / R;
  for (int j = team.rank; j < hr; j += team.size()) {
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (kFirst) {
        v[r] = first(j + r * hr);
      } else {
        v[r] = src[pad(j + r * hr)];
      }
    }
    if (ns > 1) {
      const float2* w = tw + j * (R - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], ld<kG>(w + r - 1));
    }
    dft_small<R>(v);
    const int d = ld<kG>(base + j);
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad(d + r * ns)] = v[r];
  }
}

template <bool kFirst, typename T, typename First>
__device__ inline void stage_of_radix(int R, First first, const float2* src, float2* dst, int H,
                                      int ns, const float2* tw, const int* base, const T& team) {
  switch (R) {  // uniform over the team
    case 8: stockham_stage<8, kFirst>(first, src, dst, H, ns, tw, base, team); break;
    case 4: stockham_stage<4, kFirst>(first, src, dst, H, ns, tw, base, team); break;
    case 2: stockham_stage<2, kFirst>(first, src, dst, H, ns, tw, base, team); break;
    case 3: stockham_stage<3, kFirst>(first, src, dst, H, ns, tw, base, team); break;
    default: stockham_stage<5, kFirst>(first, src, dst, H, ns, tw, base, team); break;
  }
}

// 3a. The Stockham FFT of fft_n complex points (the frame's H = n_fft/2, or
//     the Bluestein form's P) by a team (a warp, or a group of the
//     block): stage 0 loads
//     point n by first(n) (from the staged signal, or from another row),
//     each later stage the row the one before stored, ping-ponging between
//     the rows a (stage 0's output) and b, the team meeting after each
//     stage. tw holds the stage twists (after the split's entries), base
//     the output bases, stage after stage. Returns the row holding Z.
template <typename T, typename First>
__device__ inline const float2* stockham(First first, float2* a, float2* b, const Params& p,
                                         const float2* tw, const int* base, const T& team) {
  float2* dst = a;
  const float2* src = b;
  const int n = p.fft_n;
  int ns = 1;
  for (int s = 0; s < p.nstages; ++s) {
    const int R = static_cast<int>((p.radices >> (4 * s)) & 15u);
    if (s == 0) {
      stage_of_radix<true>(R, first, nullptr, dst, n, 1, tw, base, team);
    } else {
      stage_of_radix<false>(R, first, src, dst, n, ns, tw, base, team);
      tw += (n / R) * (R - 1);
    }
    base += n / R;
    team.sync();
    src = dst;
    dst = dst == a ? b : a;
    ns *= R;
  }
  return src;
}

// Real split of the half-size complex FFT Z (zat(k) = Z[k]) of
// z[n] = y[2n] + i y[2n+1]:
// Xe = (Z[k] + conj Z[H-k]) / 2, Xo = (Z[k] - conj Z[H-k]) / 2i,
// X[k] = Xe + W^k Xo and X[H-k] = conj(Xe - W^k Xo), W = e^{-2 pi i / n_fft},
// for k <= H/2 (the team's rank, rank + size, ...); |X|^2 * pscale into
// pw[k] and pw[H-k] (once when 2k = H). Returns this thread's share of the
// powers' sum (the pspec energy).
template <typename T, typename Zat>
__device__ inline float real_split(Zat zat, float* __restrict__ pw, const float2* __restrict__ tw,
                                   int H, float pscale, const T& team) {
  constexpr bool kG = T::kGlobal;
  float es = 0.f;
  for (int k = team.rank; k <= H / 2; k += team.size()) {
    const float2 a = zat(k);
    const float2 c = zat(k == 0 ? 0 : H - k);
    const float er = 0.5f * (a.x + c.x);
    const float ei = 0.5f * (a.y - c.y);
    const float orr = 0.5f * (a.y + c.y);
    const float oi = -0.5f * (a.x - c.x);
    const float2 w = ld<kG>(tw + k);
    const float wr = orr * w.x - oi * w.y;
    const float wi = orr * w.y + oi * w.x;
    const float xr = er + wr, xi = ei + wi;
    const float px = (xr * xr + xi * xi) * pscale;
    pw[k] = px;
    es += px;
    if (2 * k != H) {
      const float yr = er - wr, yi = ei - wi;
      const float py = (yr * yr + yi * yi) * pscale;
      pw[H - k] = py;
      es += py;
    }
  }
  return es;
}

// |X[k]|^2 * pscale of an odd n_fft's Bluestein outputs (zat(k) = X[k], k <
// bins) into pw; returns this thread's share of the powers' sum.
template <typename T, typename Zat>
__device__ inline float chirp_power(Zat zat, float* __restrict__ pw, int bins, float pscale,
                                    const T& team) {
  float es = 0.f;
  for (int k = team.rank; k < bins; k += team.size()) {
    const float2 x = zat(k);
    const float px = (x.x * x.x + x.y * x.y) * pscale;
    pw[k] = px;
    es += px;
  }
  return es;
}

// The warp sum of a power row (the pspec energy of the bf16x3 form).
__device__ inline float power_sum(const float* pw, int bins, int lane) {
  float es = 0.f;
  for (int k = lane; k < bins; k += 32) es += pw[k];
  return warp_sum(es);
}

// 2. The conditioned sample g[a] of the frame fr with mean mu under kCond
//    (frame pre-emphasis folded in); fr[a] otherwise.
template <bool kCond>
__device__ __forceinline__ float frame_cond(const Params& p, const float* fr, float mu, int a) {
  if constexpr (kCond) {
    const float d = fr[a] - mu;
    return a == 0 ? d * p.frame_keep0 : d - p.frame_preemph * (fr[a - 1] - mu);
  } else {
    return fr[a];
  }
}

// A frame's energy lane from its power sum es and, under kCond with an
// energy of the samples, its frame energy e_frame; 0 for SSC.
template <bool kCond>
__device__ __forceinline__ float energy_of(const Params& p, float es, float e_frame) {
  if (p.feature_kind == kSsc) return 0.f;
  if (kCond && p.energy_source != kPspec) return fmaxf(e_frame, p.eps);
  return es <= 0.f ? p.eps : es;
}

// 3. One frame's DFT by a team (a warp over its own rows ra, rb; a group of
//    the block plans or of the wide plan over its group's) from the frame
//    fr with mean mu, its windowed samples frame_cond(a) * wv[a], on the
//    tables tws (twiddles, chirp, filter) and bs (stage bases): the
//    Stockham or Bluestein form, then the real split (or the odd form's
//    powers) into pw: on entry the frame's own power row, or null for the
//    team's free row, which pw then names. Returns this thread's share of
//    the power sum, and adds its windowed samples' squares to e under wsum.
template <bool kCond, typename Team>
__device__ __forceinline__ float frame_fft(Team team, const Params& p, const float* fr, float mu,
                                           const float* wv, bool wsum, float2* ra, float2* rb,
                                           const float2* tws, const int* bs, float& e, float*& pw) {
  constexpr bool kG = Team::kGlobal;
  const int Lk = imin(p.L, p.n_fft);  // rfft(n=n_fft) truncates longer frames
  auto sample = [&](int a) -> float { return frame_cond<kCond>(p, fr, mu, a) * wv[a]; };
  if (p.form == kBluestein) {
    // 3d. the Bluestein FFT: stage 0 of the forward P-point FFT loads
    //     point n < Q (the windowed pair (y[2n], y[2n+1]) for even n_fft,
    //     the sample y[n] for odd) times the chirp c[n], zero past Q; the
    //     inverse's stage 0 loads conj(A[n]) times the filter spectrum
    //     (1/P folded in) and runs the same forward stages; Z[k] =
    //     c[k] conj(D[k]) then feeds the real split (even n_fft) or is
    //     X[k] itself (odd)
    const float2* chirp = tws + p.chirp;
    const float2* filt = tws + p.filt;
    const bool packed = (p.n_fft & 1) == 0;
    auto point = [&](int n) -> float2 {
      if (n >= p.bq) return make_float2(0.f, 0.f);
      const int a = packed ? 2 * n : n;
      const float re = a < Lk ? sample(a) : 0.f;
      const float im = packed && a + 1 < Lk ? sample(a + 1) : 0.f;
      if (wsum) e += re * re + im * im;
      return cmul(make_float2(re, im), ld<kG>(chirp + n));
    };
    float2* A = const_cast<float2*>(stockham(point, ra, rb, p, tws + p.nsplit, bs, team));
    const int P = p.fft_n;
    auto spectrum = [&](int n) -> float2 {
      const float2 x = A[pad(n)];
      return cmul(make_float2(x.x, -x.y), ld<kG>(filt + (packed ? imin(n, P - n) : n)));
    };
    const float2* D = stockham(spectrum, A == ra ? rb : ra, A, p, tws + p.nsplit, bs, team);
    if (!pw) pw = reinterpret_cast<float*>(D == ra ? rb : ra);
    auto zat = [&](int k) -> float2 {  // c[k] conj(D[k])
      const float2 d = D[pad(k)], c = ld<kG>(chirp + k);
      return make_float2(c.x * d.x + c.y * d.y, c.y * d.x - c.x * d.y);
    };
    return packed ? real_split(zat, pw, tws, p.half, p.pscale, team)
                  : chirp_power(zat, pw, p.bins, p.pscale, team);
  }
  // 3a. the Stockham FFT, stage 0 loading point n = (y[2n], y[2n+1])
  //     windowed (0 past Lk) from the frame; then the real split into pw
  auto point = [&](int n) -> float2 {
    const int a = 2 * n;
    const float re = a < Lk ? sample(a) : 0.f;
    const float im = a + 1 < Lk ? sample(a + 1) : 0.f;
    if (wsum) e += re * re + im * im;
    return make_float2(re, im);
  };
  const float2* Z = stockham(point, ra, rb, p, tws + p.nsplit, bs, team);
  if (!pw) pw = reinterpret_cast<float*>(Z == ra ? rb : ra);
  return real_split([&](int k) { return Z[pad(k)]; }, pw, tws, p.half, p.pscale, team);
}

// 2-3. Frame f of a group (the block plans' group loop, the wide plan's
//     stage 1) through its rows ra, rb. 2z: a frame wholly past its row's
//     length (framed) zeroes its power row (pw, or ra where pw is null).
//     Else 2g, under `gather`: the frame's first Lk samples from device
//     memory into rb (stage 0 of the first FFT reads it and writes ra);
//     dev(a), any a < L, the same value from device memory; otherwise fr,
//     the frame in the staged span. 2: the conditioning's mean and raw
//     energy as group sums; 3: frame_fft into pw (frame_fft's rule); then
//     the windowed energy of the samples past Lk. es: the group's power
//     sum; e_frame: under kCond, the group's frame energy (else 0). wv: the
//     window the DFT's loads read, window: its device-memory copy.
template <bool kDither, bool kCond, typename Team, typename Sample>
__device__ __forceinline__ void group_frame(Team team, const Params& p, const Sample* row, long long len, int f,
                                            bool framed, bool gather, const float* fr, const float* wv,
                                            const float* __restrict__ window, float2* ra, float2* rb,
                                            const float2* tws, const int* bs, float* red, float*& pw, float& es,
                                            float& e_frame) {
  const int L = p.L, Lk = imin(L, p.n_fft), rank = team.rank, gsize = team.size();
  const bool wsum = kCond && p.energy_source == kWindowedFrame;
  auto gsum = [&](float v) { return group_sum(v, red, team); };
  e_frame = 0.f;
  if (framed && static_cast<long long>(f) * p.S >= len) {  // 2z
    if (!pw) pw = reinterpret_cast<float*>(ra);
    for (int k = rank; k < p.bins; k += gsize) pw[k] = 0.f;
    es = 0.f;
    return;
  }
  const long long tf = static_cast<long long>(f) * p.S;
  auto dev = [&](int a) -> float { return staged_at<kDither>(row, tf + a, len, p); };
  if (gather) {
    float* g = reinterpret_cast<float*>(rb);
    for (int a = rank; a < Lk; a += gsize) g[a] = dev(a);
    team.sync();
    fr = g;
  }
  auto x_at = [&](int a) -> float { return gather && a >= Lk ? dev(a) : fr[a]; };
  float mu = 0.f, e = 0.f;
  if constexpr (kCond) {
    if (p.remove_dc) {
      float s = 0.f;
      for (int a = rank; a < L; a += gsize) s += x_at(a);
      mu = gsum(s) / static_cast<float>(L);
    }
    if (p.energy_source == kRawFrame) {
      for (int a = rank; a < L; a += gsize) {
        const float d = x_at(a) - mu;
        e += d * d;
      }
    }
  }
  es = gsum(frame_fft<kCond>(team, p, fr, mu, wv, wsum, ra, rb, tws, bs, e, pw));
  if (wsum) {
    for (int a = Lk + rank; a < L; a += gsize) {
      float x;
      if (gather) {  // the rows hold the FFT now: both samples from device memory
        const float d = dev(a) - mu;
        x = (d - p.frame_preemph * (dev(a - 1) - mu)) * __ldg(window + a);
      } else {
        x = frame_cond<kCond>(p, fr, mu, a) * wv[a];
      }
      e += x * x;
    }
  }
  if constexpr (kCond) {
    if (p.energy_source != kPspec) e_frame = gsum(e);
  }
}

// Views of the packed mel bands, staged in shared memory or (bands_global)
// in device memory: filter m's weights are w[off[m] .. off[m+1]) (wf:
// melf, ssc), off strictly increasing from off[0] = 0 (every filter owns a
// weight); meta[i] is weight i's bin, with the sign bit set on a filter's
// last weight (kernels/frontend.py mel_packed, packed_meta). No word names
// a filter: the projection counts them from filter_of.
struct Bands {
  const float* w;
  const float* wf;
  const int* off;
  const int* meta;
};

__device__ inline int meta_bin(int e) { return e & 0x7fffffff; }

// The filter whose weights hold packed index i < off[M]: the last m with
// off[m] <= i, by a binary search of off[0 .. M].
__device__ inline int filter_of(const int* off, int M, int i) {
  int lo = 0, hi = M;  // off[lo] <= i < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= i) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The filter a team member's chunk of c weights [rank c, rank c + c)
// starts inside (filter_of; 0 past the table), and into from the member
// where that filter began (-1 when the chunk starts a filter, or lies past
// the table): write_frame's m0 and from, found once a tile.
__device__ inline int chunk_filter(const int* off, int M, int nnz, int c, int rank, int& from) {
  from = -1;
  if (rank * c >= nnz) return 0;
  const int m0 = filter_of(off, M, rank * c);
  if (off[m0] < rank * c) from = off[m0] / c;
  return m0;
}

// 4. One frame's output row o from its power row pw (pw[k], k < bins), by
//    feature kind, by a team (a warp, or a group of the block plan; lane
//    below is the thread's rank in it): the projection over the
//    packed bands, then the log kind (logmel), nothing (plp) or the
//    centroid (ssc, over the clamped powers); the log kind of power bin m
//    (spectrogram). Lane l sums the packed weights [l c, l c + c) in order
//    (c = chunk: p.chunk for a warp, p.bchunk for a group), starting inside
//    filter m0 (filter_of its first weight) and counting one filter on at
//    each sign bit: a filter that ends in the lane's chunk has its sum
//    stored to sum[m] there, the partial of the one that goes on is posted
//    to part[l], and the filter m0, where it began in an earlier lane
//    `from` (the lane whose chunk holds off[m0]; -1 when the chunk starts
//    a filter, or lies past the table), is summed by the lane it ends in as
//    part[from] + ... + part[l-1] + its own sum. Then lane m
//    takes the log kind (or the ratio) of sum[m], m, m + size, ..., off the
//    divergent loop, and lane 0 writes `energy` to o[M]. scratch holds part
//    [size] and sum [M] (for ssc then the melf ones); under "gather_sums"
//    (kGlobal and p.sums_global) it holds part and partf alone, sum is the
//    output row o itself and sumf is `sums` in the workspace.
template <typename T>
__device__ inline void write_frame(float* o, const float* pw, float energy, const Bands& bd,
                                   float* scratch, float* sums, int from, int m0, int chunk,
                                   const Params& p, const T& team) {
  const int M = p.M, kind = p.feature_kind, lane = team.rank, lanes = team.size();
  if (kind == kSpectrogram) {
    for (int m = lane; m < M; m += lanes) o[m] = log_lane(pw[m], p);
  } else {
    const bool ssc = kind == kSsc;
    float* part = scratch;
    float* sum = scratch + lanes;
    float* partf = sum + M;  // ssc only
    float* sumf = partf + lanes;
    if constexpr (T::kGlobal) {
      if (p.sums_global) {  // "gather_sums": the sums in device memory
        partf = scratch + lanes;
        sum = o;
        sumf = sums;
      }
    }
    const int i0 = lane * chunk, i1 = imin(i0 + chunk, p.nnz);
    float acc = 0.f, accf = 0.f, hacc = 0.f, haccf = 0.f;
    int held = -1;  // the filter begun in lane `from` that ends in this one
    bool head = from >= 0;
    int filt = m0;  // the filter of weight i
    for (int i = i0; i < i1; i += kProjBatch) {
      // a batch's loads first: the sums' stores below would order them
      int e[kProjBatch];
      float q[kProjBatch], w[kProjBatch], wf[kProjBatch];
#pragma unroll
      for (int u = 0; u < kProjBatch; ++u) {
        const bool in = i + u < i1;
        e[u] = in ? bd.meta[i + u] : 0;
        w[u] = in ? bd.w[i + u] : 0.f;
        wf[u] = in && ssc ? bd.wf[i + u] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kProjBatch; ++u) q[u] = pw[meta_bin(e[u])];
#pragma unroll
      for (int u = 0; u < kProjBatch; ++u) {
        if (i + u >= i1) break;
        if (ssc) {
          q[u] = q[u] <= 0.f ? p.eps : q[u];
          accf += q[u] * wf[u];
        }
        acc += q[u] * w[u];
        if (e[u] < 0) {  // the last weight of filter filt
          if (head) {
            hacc = acc;
            haccf = accf;
            held = filt;
            head = false;
          } else {
            sum[filt] = acc;
            if (ssc) sumf[filt] = accf;
          }
          acc = accf = 0.f;
          ++filt;
        }
      }
    }
    part[lane] = acc;
    if (ssc) partf[lane] = accf;
    team.sync();
    if (held >= 0) {
      float s = part[from], sf = ssc ? partf[from] : 0.f;
      for (int l = from + 1; l < lane; ++l) {
        s += part[l];
        if (ssc) sf += partf[l];
      }
      sum[held] = s + hacc;
      if (ssc) sumf[held] = sf + haccf;
    }
    team.sync();
    for (int m = lane; m < M; m += lanes) {
      o[m] = ssc ? __fdiv_rn(sumf[m], sum[m]) : kind == kPlp ? sum[m] : log_lane(sum[m], p);
    }
  }
  if (lane == 0) o[M] = energy;
}

// 3c. The bf16x3 form's pieces (kBf16x3): the ring's mbarriers and bulk
//     copies, wgmma's shared-memory descriptor and its m64n136k16 product
//     with A from registers (sm_90a).
__device__ inline uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      :
      : "r"(smem_u32(bar)), "r"(bytes)
      : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :
               : "r"(smem_u32(bar))
               : "memory");
}

// Spins until the phase of `bar` with the given parity has completed.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One asynchronous bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into this block's shared memory, completing
// on `bar`'s transaction count.
__device__ inline void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// wgmma's descriptor of a K-major B operand without swizzle: core matrices
// of 8 columns x 16 bytes (8 bf16 of K), the two K halves of a k16 step 128 B
// apart (leading byte offset), 8-column groups 256 B apart (stride byte
// offset); the address and both offsets in 16-byte units.
__device__ inline uint64_t b_desc(const void* ptr) {
  return static_cast<uint64_t>((smem_u32(ptr) >> 4) & 0x3FFF) |
         static_cast<uint64_t>(128 >> 4) << 16 | static_cast<uint64_t>(256 >> 4) << 32;
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Waits until at most N committed groups of products are still in flight.
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers across
// the asynchronous product (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ inline void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ inline void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[64 x 136] += a[64 x 16] (bf16, this thread's fragment) x B[16 x 136]
// (bf16, shared memory at desc), fp32 accumulation. Thread (warp w, lane
// 4g + t) holds a[q] = rows 16w + g + 8 (q & 1), columns 2t + 8 (q >> 1) and
// + 1 (the lower column in the low half), and d[4j + 2h + c] = row
// 16w + g + 8h, column 8j + 2t + c.
__device__ inline void wgmma_m64n136k16(float (&d)[68], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %73, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The same product with A from shared memory too (descriptor a, K-major
// core matrices as B's: the two K halves 128 B apart, 8-row groups 256 B
// apart): d[4j + 2h + c] = row 16w + g + 8h, column 8j + 2t + c.
__device__ inline void wgmma_m64n136k16_ss(float (&d)[68], uint64_t a, uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %70, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67}, "
      "%68, %69, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67])
      : "l"(a), "l"(desc), "r"(1));
}

__device__ inline uint32_t bf16_pair(__nv_bfloat16 lo_col, __nv_bfloat16 hi_col) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_col)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi_col)) << 16;
}

// One tile of the block's frames: frames [tx * tile, (tx + 1) * tile) of
// row b; slot, the block's slot of the "gather_rows" workspace.
template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
__device__ __forceinline__ void
logmel_tile(const Sample* __restrict__ audio, const int* __restrict__ lengths,
            float* __restrict__ out, int* __restrict__ n_valid, float* __restrict__ frame_mask,
            const float* __restrict__ window,
            const float* __restrict__ mel_w, const float* __restrict__ melf_w,
            const int* __restrict__ mel_off, const int* __restrict__ mel_meta,
            const float2* __restrict__ twiddle, const int* __restrict__ bases,
            const unsigned char* __restrict__ dft_matrix, const float* __restrict__ taps,
            float* __restrict__ rows_ws, const Params& p, const Polyphase& pp, int b, int tx,
            int slot) {
  extern __shared__ __align__(128) float smem[];
  const int T = p.T, F = p.F, L = p.L, S = p.S, M = p.M;
  const int kind = p.feature_kind;
  const float preemph = p.preemph;
  const Layout lay = kResample ? layout(p, resample_floats<Sample>(p, pp), pp.up * pp_stride(pp), true, false)
                               : layout(p, 0, 0, kDither, kBlock);  // kDither: the wide row
  float* sig = smem;
  float* win = smem + lay.win;
  int* moff = reinterpret_cast<int*>(smem + lay.moff);
  int* meta = reinterpret_cast<int*>(smem + lay.meta);
  const Bands bd{smem + lay.melw, smem + lay.melf, moff, meta};
  float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
  int* sb = reinterpret_cast<int*>(smem + lay.bases);

  const int tile = kBf16 ? p.tile : kTile;  // frames a block
  const int f0 = tx * tile;
  const long long t0 = static_cast<long long>(f0) * S;
  const Sample* row = audio + static_cast<size_t>(b) * T + p.origin;  // x[0]; x[-1] under origin 1
  const bool gather = kBlock && p.gather;  // no span and no window staged (step 2g)
  // the window the DFT's loads read: staged, or the gather plan's in device
  // memory, one pointer chosen a block (a choice at each load cost the
  // staged block plan 4-11 %; scripts/block_plan_sweep.py --parent)
  const float* wv = gather ? window : win;

  if (!gather) {
    const int wlen = imax(L, p.n_fft);
    for (int i = threadIdx.x; i < wlen; i += kThreads) win[i] = i < L ? window[i] : 0.f;
  }
  if (kind != kSpectrogram && !(kBlock && p.bands_global)) {  // else read from device memory
    float* w = smem + lay.melw;
    float* wf = smem + lay.melf;
    for (int i = threadIdx.x; i < p.nnz; i += kThreads) {
      w[i] = mel_w[i];
      meta[i] = mel_meta[i];
      if (kind == kSsc) wf[i] = melf_w[i];
    }
    for (int i = threadIdx.x; i <= M; i += kThreads) moff[i] = mel_off[i];
  }
  if (!(kBlock && p.tables_global)) {  // "block_global" reads them from device memory
    for (int i = threadIdx.x; i < p.ntw; i += kThreads) tw[i] = twiddle[i];
    for (int i = threadIdx.x; i < p.nbases; i += kThreads) sb[i] = bases[i];
  }

  // the row's length at the frame rate's sample rate (the output length of
  // the fused resample): under non-centered framing a frame that starts at
  // or past it holds only zeros (step 2z), and so does every frame of a tile
  // that starts there, which then stages nothing
  const int len_in = max(0, min(lengths[b], T - p.origin));
  const long long len = kResample ? pp_output_length(len_in, pp) : len_in;
  const bool framed = p.center == kNoCenter;
  const bool stage = !framed || t0 < len;

  // the row's valid frame count from its length as given (the output length
  // of the fused resample, 64-bit), the mask of the block's frames, and the
  // count from the row's first block
  const int nv = valid_frames(kResample ? pp_output_length(lengths[b], pp) : lengths[b], p);
  for (int i = threadIdx.x; i < tile && f0 + i < F; i += kThreads) {
    frame_mask[static_cast<size_t>(b) * F + f0 + i] = f0 + i < nv ? 1.f : 0.f;
  }
  if (tx == 0 && threadIdx.x == 0) n_valid[b] = nv;

  // bf16x3: the ring of matrix chunks, its full and empty mbarriers; a tile
  // that stages nothing takes no product. The producer thread starts the
  // first stages' copies now, so they overlap the staging.
  const bool dft = stage;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem + lay.buf);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  uint64_t* empty = full + p.stages;
  if constexpr (kBf16) {
    if (dft && threadIdx.x == kProducer) {
      for (int i = 0; i < p.stages; ++i) {
        mbar_init(full + i, 1);
        mbar_init(empty + i, kConsumers);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      const int first = imin(p.stages, p.npass * (p.kp / kBfStep));
      for (int c = 0; c < first; ++c) {
        mbar_expect_tx(full + c, kBfStageBytes);
        bulk_copy(ring + c * kBfStageBytes, dft_matrix + static_cast<size_t>(c) * kBfStageBytes,
                  kBfStageBytes, full + c);
      }
    }
  }

  if constexpr (kResample) {
    // 1r. the input window (the rows' own int16 or float32, copied
    //     asynchronously, then zeroed at t_in >= length) over the warps'
    //     rows, and the taps; the FIR (polyphase.cuh pp_block) writes
    //     x[t0-1 .. t0+span) into the signal row (x[-1] = 0, and 0 past the
    //     output length); under kDither a pass adds the noise at output
    //     positions; then pre-emphasis and zeroing in place, a chunk at a
    //     time: each thread reads its pairs, the block meets, then writes
    //     (the next chunk reads only what no thread has written yet)
    if (stage) {
      const int n = lay.span + 1;
      const long long lo = pp_first_input(t0 - 1, pp);
      const int in_len = resample_window(p, pp);
      Sample* win_s = reinterpret_cast<Sample*>(smem + lay.fir);
      Sample* in = win_s + pp_stage(win_s, audio, static_cast<long long>(gridDim.y) * T,
                                    static_cast<long long>(b) * T, lo, in_len, p.aligned != 0);
      pp_copies_commit();
      float* tab = smem + lay.tab;
      const int ntab = pp.up * pp_stride(pp);
      for (int i = threadIdx.x; i < ntab; i += kThreads) tab[i] = taps[i];
      pp_copies_wait<0>();
      __syncthreads();
      if (pp_needs_mask(lo, in_len, len_in)) {  // the row's start, or samples past its length
        pp_mask(in, lo, in_len, len_in);
        __syncthreads();
      }
      const int live_lo = t0 == 0 ? 1 : 0;  // x[-1] = 0
      const int live_hi = static_cast<int>(min(static_cast<long long>(n), len - t0 + 1));
      pp_block(t0 - 1, n, live_lo, live_hi, lo, in, tab, pp, [=](int i, float x) { sig[i] = x; });
      __syncthreads();
      if constexpr (kDither) {  // in place: each entry on its own
        for (int i = live_lo + threadIdx.x; i < live_hi; i += kThreads) {
          sig[i] = dithered(sig[i], static_cast<uint32_t>(t0 - 1 + i), p);
        }
        __syncthreads();
      }
      for (int c0 = 0; c0 < lay.span; c0 += kThreads * kStageBatch) {
        float v[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int i = c0 + u * kThreads + threadIdx.x;
          v[u] = i < lay.span && t0 + i < len ? sig[i + 1] - preemph * sig[i] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int i = c0 + u * kThreads + threadIdx.x;
          if (i < lay.span) sig[i] = v[u];
        }
      }
    }
  } else if (gather) {
    // the gather plan stages nothing: each group reads its frames from
    // device memory (step 2g)
  } else if (!framed) {
    // 1c. centered framing: staged position t = t0 + offset + i reads the
    //     source index r = reflect(t, max(len, 1)) and stages
    //     y[r] = x[r] - c x[r-1] (x[-1] = 0; dithered x keyed on r under
    //     kDither), 0 when r >= len: pre-emphasis and noise at the source
    //     index, as the signal is pre-emphasized before it is reflected
    const long long n = len > 0 ? len : 1;
    for (int i0 = threadIdx.x; i0 < lay.span; i0 += kThreads * kStageBatch) {
      long long r[kStageBatch];
      float x[kStageBatch], xp[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        r[u] = reflect(t0 + p.offset + i0 + u * kThreads, n, p.center);
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {  // the indices first, so the loads issue together
        const bool in = i0 + u * kThreads < lay.span && r[u] < len;
        x[u] = in ? source<kDither>(row, r[u], p) : 0.f;
        xp[u] = in && preemph != 0.f && r[u] > 0 ? source<kDither>(row, r[u] - 1, p) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < lay.span) sig[i] = preemph != 0.f ? x[u] - preemph * xp[u] : x[u];
      }
    }
  } else if (stage) {
    if constexpr (kDither) {
      // 1d. x[t0-o .. t0+span) converted into the signal row (o = 1 under
      //     signal pre-emphasis, 0 in frame mode, where the host passes
      //     preemph = 0), 0 outside [0, length), the loads kStageBatch at a
      //     time; then the dither pass in place at positions 0 <= t <
      //     length; then, for o = 1, pre-emphasis and zeroing in place, a
      //     chunk at a time, as the fused resample does (1r)
      const int o = preemph != 0.f ? 1 : 0;
      const int n = lay.span + o;
      const long long ts = t0 - o;  // sig[i] holds x[ts + i]
      for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kStageBatch) {
        float x[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const long long t = ts + i0 + u * kThreads;
          x[u] = i0 + u * kThreads < n && t >= 0 && t < len ? source<false>(row, t, p) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n) sig[i] = x[u];
        }
      }
      __syncthreads();
      const int live_lo = ts < 0 ? 1 : 0;  // ts >= -1
      const int live_hi = static_cast<int>(min(static_cast<long long>(n), len - ts));
      for (int i = live_lo + threadIdx.x; i < live_hi; i += kThreads) {
        sig[i] = dithered(sig[i], static_cast<uint32_t>(ts + i), p);
      }
      if (o) {
        __syncthreads();
        for (int c0 = 0; c0 < lay.span; c0 += kThreads * kStageBatch) {
          float v[kStageBatch];
#pragma unroll
          for (int u = 0; u < kStageBatch; ++u) {
            const int i = c0 + u * kThreads + threadIdx.x;
            v[u] = i < lay.span && t0 + i < len ? sig[i + 1] - preemph * sig[i] : 0.f;
          }
          __syncthreads();
#pragma unroll
          for (int u = 0; u < kStageBatch; ++u) {
            const int i = c0 + u * kThreads + threadIdx.x;
            if (i < lay.span) sig[i] = v[u];
          }
        }
      }
    } else {
      // 1. stage the tile's span: convert, pre-emphasis, then zero t >= length
      for (int i0 = threadIdx.x; i0 < lay.span; i0 += kThreads * kStageBatch) {
        float x[kStageBatch], xp[kStageBatch];
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const long long t = t0 + i0 + u * kThreads;
          const bool in = i0 + u * kThreads < lay.span && t < len;
          x[u] = in ? source<false>(row, t, p) : 0.f;
          xp[u] = in && t + p.origin > 0 ? source<false>(row, t - 1, p) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kStageBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < lay.span) sig[i] = x[u] - preemph * xp[u];
        }
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int Lk = min(L, p.n_fft);  // rfft(n=n_fft) truncates longer frames
  float* part = smem + lay.part + warp * lay.pstride;
  // step 4: the filter this lane's chunk starts inside and the lane where
  // it began (chunk_filter; the bf16x3 form's staged plan finds them just
  // before its epilogue, so they do not live across its products)
  int m0 = 0, from = -1;
  if (!kBlock && !kBf16 && kind != kSpectrogram) m0 = chunk_filter(moff, M, p.nnz, p.chunk, lane, from);
  auto energy_lane = [&](float es, float e_frame) -> float { return energy_of<kCond>(p, es, e_frame); };

  // 2. per frame, the conditioning over the frame's L samples under kCond:
  //    mean and raw energy of the centered frame (frame_stats); cond(a) is
  //    the conditioned sample g[a] (frame pre-emphasis folded in), sample(a)
  //    the windowed one
  auto frame_stats = [&](const float* fr, float& mu, float& e) {
    mu = 0.f;
    e = 0.f;
    if constexpr (kCond) {
      if (p.remove_dc) {
        float s = 0.f;
        for (int a = lane; a < L; a += 32) s += fr[a];
        mu = warp_sum(s) / static_cast<float>(L);
      }
      if (p.energy_source == kRawFrame) {
        for (int a = lane; a < L; a += 32) {
          const float d = fr[a] - mu;
          e += d * d;
        }
      }
    }
  };
  auto cond = [&](const float* fr, float mu, int a) -> float { return frame_cond<kCond>(p, fr, mu, a); };
  const bool wsum = kCond && p.energy_source == kWindowedFrame;

  if constexpr (kBf16) {
    // 2b. each frame's mean and energies under kCond (zeros past F and in a
    //     tile that takes no product), into mu and ef
    float* pw_tile = smem + lay.pw;
    float* ef = smem + lay.ef;
    float* mu_t = smem + lay.mu;
    for (int fl = warp; fl < tile; fl += kWarps) {
      float mu = 0.f, e = 0.f;
      if (dft && f0 + fl < F) {  // warp-uniform
        const float* fr = sig + fl * S;
        frame_stats(fr, mu, e);
        if (wsum) {
          for (int a = lane; a < L; a += 32) {
            const float v = cond(fr, mu, a) * win[a];
            e += v * v;
          }
        }
        if constexpr (kCond) {
          if (p.energy_source != kPspec) e = warp_sum(e);
        }
      }
      if (lane == 0) {
        ef[fl] = e;
        mu_t[fl] = mu;
      }
    }
    __syncthreads();
    // 3c. the tile's DFT on the tensor cores into the power rows: the
    //     consumer warpgroup (warps 0-3) takes 16 frames a warp, pass after
    //     pass over 136 bins, step after step over k16 slices of the ring;
    //     the producer thread keeps the ring full.
    if (!dft) {
      for (int i = threadIdx.x; i < tile * p.pws; i += kThreads) pw_tile[i] = 0.f;
    } else if (threadIdx.x < kConsumers) {
      const int g = lane >> 2, t = lane & 3;
      const int r0 = 16 * warp + g;
      const int steps = p.kp / kBfStep;
      const float* fr[2];
      float mu[2];
      bool live[2];
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        live[h] = r < tile && f0 + r < F;
        fr[h] = sig + (live[h] ? r : 0) * S;
        mu[h] = live[h] ? mu_t[r] : 0.f;
      }
      // conditioned sample a of row h's frame
      auto value = [&](int h, int a) -> float { return cond(fr[h], mu[h], a); };
      // the step's A fragment, hi and lo of the conditioned samples
      // (unwindowed: the matrix carries the window), zero past Lk
      auto fragment = [&](int k0, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1;
          const int a = k0 + 2 * t + 8 * (q >> 1);
          const float v0 = live[h] && a < Lk ? value(h, a) : 0.f;
          const float v1 = live[h] && a + 1 < Lk ? value(h, a + 1) : 0.f;
          const __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
          ah[q] = bf16_pair(h0, h1);
          al[q] = bf16_pair(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
                            __float2bfloat16_rn(v1 - __bfloat162float(h1)));
        }
      };
      int c = 0;  // the ring's chunk: pass * steps + step
      for (int pass = 0; pass < p.npass; ++pass) {
        float re0[68], re1[68];  // bins [0, 68) and [68, 136) of the pass
#pragma unroll
        for (int i = 0; i < 68; ++i) re0[i] = re1[i] = 0.f;
#pragma unroll 1
        for (int s = 0; s < steps; ++s, ++c) {
          uint32_t ah[4], al[4];
          fragment(s * kBfStep, ah, al);
          const int slot = c % p.stages;
          mbar_wait(full + slot, (c / p.stages) & 1);
          __syncwarp();
          const unsigned char* st = ring + slot * kBfStageBytes;
          const uint64_t wh = b_desc(st), wl = b_desc(st + kBfPartBytes);
          const uint64_t second = (kBfGroups / 2) * 256 >> 4;  // columns [136, 272)
          wgmma_fence();
          fence_regs(re0);
          fence_regs(re1);
          wgmma_m64n136k16(re0, ah, wh);
          wgmma_m64n136k16(re1, ah, wh + second);
          wgmma_m64n136k16(re0, al, wh);
          wgmma_m64n136k16(re1, al, wh + second);
          wgmma_m64n136k16(re0, ah, wl);
          wgmma_m64n136k16(re1, ah, wl + second);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(re0);
          fence_regs(re1);
          fence_regs(ah);
          fence_regs(al);
          mbar_arrive(empty + slot);
        }
        // |X|^2 of each bin from its (cosine, sine) column pair, in registers,
        // into its power row
        auto store = [&](const float (&d)[68], int bin0) {
#pragma unroll
          for (int j = 0; j < 17; ++j) {
            const int bin = bin0 + 4 * j + t;
            if (bin >= p.bins) break;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 8 * h;
              const float x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
              if (r < tile) {
                pw_tile[r * p.pws + bin] =
                    __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
              }
            }
          }
        };
        store(re0, pass * kBfPassBins);
        store(re1, pass * kBfPassBins + kBfPassBins / 2);
      }
    } else if (threadIdx.x == kProducer) {
      const int total = p.npass * (p.kp / kBfStep);
      for (int c = p.stages; c < total; ++c) {  // the first stages went out at the start
        const int slot = c % p.stages;
        mbar_wait(empty + slot, ((c / p.stages) & 1) ^ 1);
        mbar_expect_tx(full + slot, kBfStageBytes);
        bulk_copy(ring + slot * kBfStageBytes, dft_matrix + static_cast<size_t>(c) * kBfStageBytes,
                  kBfStageBytes, full + slot);
      }
    }
    __syncthreads();
    // 4. each frame's output row (the powers carry the matrix's scale)
    if (kind != kSpectrogram) m0 = chunk_filter(moff, M, p.nnz, p.chunk, lane, from);
    for (int fl = warp; fl < tile; fl += kWarps) {
      const int f = f0 + fl;
      if (f >= F) break;  // warp-uniform
      const float* pw = pw_tile + fl * p.pws;
      const float energy = energy_lane(power_sum(pw, p.bins, lane), ef[fl]);
      write_frame(out + (static_cast<size_t>(b) * F + f) * (M + 1), pw, energy, bd, part, nullptr,
                  from, m0, p.chunk, p, WarpTeam{lane});
      __syncwarp();  // part is rewritten by the warp's next frame
    }
  } else {
    if constexpr (!kBlock) {
      float* rows = smem + lay.buf + warp * lay.pstride;  // the warp's two rows
      float2* ra = reinterpret_cast<float2*>(rows);
      float2* rb = reinterpret_cast<float2*>(rows + lay.row);
      for (int fl = warp; fl < kTile; fl += kWarps) {
        const int f = f0 + fl;
        if (f >= F) break;  // warp-uniform
        float* pw = nullptr;
        float es, e_frame = 0.f;
        if (framed && static_cast<long long>(f) * S >= len) {
          // 2z. a frame wholly past its row's length: zero samples, zero powers
          pw = rows;
          for (int k = lane; k < p.bins; k += 32) pw[k] = 0.f;
          es = 0.f;
        } else {
          const float* fr = sig + fl * S;
          // 2. under kCond the conditioning over the frame's L samples: mean,
          //    raw energy of the centered frame, then frame pre-emphasis folded
          //    into the DFT's loads, and the windowed energy of all L samples
          //    (those past n_fft too)
          float mu, e;
          frame_stats(fr, mu, e);
          es = warp_sum(frame_fft<kCond>(WarpTeam{lane}, p, fr, mu, wv, wsum, ra, rb, tw, sb, e, pw));
          if (wsum) {
            for (int a = Lk + lane; a < L; a += 32) {
              const float x = cond(fr, mu, a) * win[a];
              e += x * x;
            }
          }
          if constexpr (kCond) {
            if (p.energy_source != kPspec) e_frame = warp_sum(e);
          }
        }
        __syncwarp();
        write_frame(out + (static_cast<size_t>(b) * F + f) * (M + 1), pw, energy_lane(es, e_frame),
                    bd, part, nullptr, from, m0, p.chunk, p, WarpTeam{lane});
        __syncwarp();  // the rows and partials are rewritten by the warp's next frame
      }
    } else {
      // the block plan: p.groups groups of gsize threads, group g taking the
      // tile's frames g, g + groups, ... one at a time through its own two
      // rows, meeting at named barrier 1 + g; the tables staged (tw, sb) or
      // in device memory (twiddle, bases)
      const int gsize = kThreads / p.groups;
      const int group = threadIdx.x / gsize, rank = threadIdx.x % gsize;
      float* scratch = smem + lay.part + group * lay.pstride;
      float* red = smem + lay.red;
      auto frames = [&](auto team, const float2* tws, const int* bs) {
        constexpr bool kG = decltype(team)::kGlobal;
        // the group's two rows: staged, or (kG, "gather_rows") in its slot
        // of the workspace, written and read by the group under its
        // barrier: plain loads, never the read-only path. The packed bands:
        // staged, or from device memory, one pointer a block.
        float* rows = kG ? rows_ws + (static_cast<size_t>(slot) * p.groups + group) * 2 * lay.row
                         : smem + lay.buf + group * 2 * lay.row;
        float2* ra = reinterpret_cast<float2*>(rows);
        float2* rb = reinterpret_cast<float2*>(rows + lay.row);
        const Bands bg = p.bands_global ? Bands{mel_w, melf_w, mel_off, mel_meta} : bd;
        // the filter this thread's chunk starts inside and the group's
        // thread where it began (chunk_filter)
        int gfrom = -1;
        const int gm0 = kind != kSpectrogram ? chunk_filter(bg.off, M, p.nnz, p.bchunk, rank, gfrom) : 0;
        // "gather_sums": SSC's melf sums, the group's M floats of its slot
        // after every slot's rows (formed at each call, so nothing more
        // lives across the frame's FFT)
        auto sums = [&]() -> float* {
          if (!kG || !p.sums_global) return nullptr;
          return rows_ws + static_cast<size_t>(p.nslots) * p.groups * 2 * lay.row +
                 (static_cast<size_t>(slot) * p.groups + group) * M;
        };
        for (int fl = group; fl < kTile; fl += p.groups) {
          const int f = f0 + fl;
          if (f >= F) break;  // group-uniform
          // 2-3. the frame (group_frame: 2z, or 2g under the gather plans,
          //      the conditioning, the FFT) into the group's free row
          float* pw = nullptr;
          float es, e_frame;
          group_frame<kDither, kCond>(team, p, row, len, f, framed, gather, sig + fl * S, wv, window, ra, rb, tws,
                                      bs, red, pw, es, e_frame);
          team.sync();  // the power row is whole
          write_frame(out + (static_cast<size_t>(b) * F + f) * (M + 1), pw, energy_lane(es, e_frame),
                      bg, scratch, sums(), gfrom, gm0, p.bchunk, p, team);
          team.sync();  // the rows and partials are rewritten by the group's next frame
        }
      };
      if (p.rows_global) {  // "gather_rows": the tables by __ldg, the rows in the workspace
        frames(GroupTeam<true>{rank, gsize, 1 + group}, twiddle, bases);
      } else {  // the rows staged; the tables staged or in device memory, one pointer a block
        frames(GroupTeam<false>{rank, gsize, 1 + group}, p.tables_global ? twiddle : tw,
               p.tables_global ? bases : sb);
      }
    }
  }
}

// kBlock: the block plan (the plain form's Stockham and Bluestein forms
// only; two blocks an SM at most 128 registers a thread). A tile a block
// (blockIdx.x of row blockIdx.y); under "gather_rows" a persistent grid of
// nslots blocks, at most the blocks the card holds at once, block i taking
// tiles i, i + gridDim.x, ... of the batch one after another through slot i
// of the workspace, so no two blocks share rows. p and pp are grid
// constants: the tile reads them in place, by reference.
template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock = false>
__global__ void __launch_bounds__(kThreads, kBf16 ? 1 : kBlock ? 2 : kFftBlocks)
logmel_kernel(const Sample* __restrict__ audio, const int* __restrict__ lengths,
              float* __restrict__ out, int* __restrict__ n_valid, float* __restrict__ frame_mask,
              const float* __restrict__ window,
              const float* __restrict__ mel_w, const float* __restrict__ melf_w,
              const int* __restrict__ mel_off, const int* __restrict__ mel_meta,
              const float2* __restrict__ twiddle, const int* __restrict__ bases,
              const unsigned char* __restrict__ dft_matrix, const float* __restrict__ taps,
              float* __restrict__ rows_ws, const __grid_constant__ Params p,
              const __grid_constant__ Polyphase pp) {
  if constexpr (kBlock) {  // one call of the tile, so it is inlined once; only w lives across it
    for (int w = p.rows_global ? blockIdx.x : 0;; w += gridDim.x) {
      const int nx = (p.F + p.tile - 1) / p.tile;
      logmel_tile<Sample, kResample, kDither, kCond, kBf16, kBlock>(
          audio, lengths, out, n_valid, frame_mask, window, mel_w, melf_w, mel_off, mel_meta, twiddle,
          bases, dft_matrix, taps, rows_ws, p, pp, p.rows_global ? w / nx : blockIdx.y,
          p.rows_global ? w % nx : blockIdx.x, blockIdx.x);
      if (!p.rows_global || static_cast<long long>(w) + gridDim.x >= static_cast<long long>(p.batch) * nx) {
        break;
      }
      __syncthreads();  // the next tile rewrites the block's shared memory
    }
  } else {
    logmel_tile<Sample, kResample, kDither, kCond, kBf16, kBlock>(
        audio, lengths, out, n_valid, frame_mask, window, mel_w, melf_w, mel_off, mel_meta, twiddle,
        bases, dft_matrix, taps, rows_ws, p, pp, blockIdx.y, blockIdx.x, 0);
  }
}

// 3b. The bf16x3 form's block plans (kBf16 with kBlock; the plain form
//     only): one tile of p.tile frames (128) of row blockIdx.y a
//     block, 384 threads in three warpgroups. The tile's A, hi and lo of each
//     frame's conditioned samples, is built once by every thread (the
//     frame's samples by staged_at from device memory, the conditioning's
//     mean first), into shared memory ("pass") or the tile's rows of the
//     workspace ("gather" and after), in wgmma's K-major core matrices step
//     by step: [hi | lo][8-frame group][K half][frame][k]. Then the roles
//     split (setmaxnreg): warp 8's lane 0 keeps the ring full (each stage a
//     matrix chunk and, in the workspace's plans, the step's A chunk); the
//     consumer warpgroups (warps 0-7) take each chunk together, 64 frames
//     each over the pass's 272 columns, A and B from shared memory through
//     descriptors, one step's products kept in flight behind the next
//     (wait_group 1, each stage released once the group that read it
//     retired); the projectors (warps 9-11) project pass p from the power
//     rows while the consumers run pass p + 1, and the consumers, when they
//     reach the next handoff, take what is left of it. The last pass is
//     projected and the epilogue written by the consumers and projectors
//     together.
template <typename Sample, bool kDither, bool kCond>
__global__ void __launch_bounds__(kBfThreads, 1)
logmel_kernel_bf16(const Sample* __restrict__ audio, const int* __restrict__ lengths,
                   float* __restrict__ out, int* __restrict__ n_valid, float* __restrict__ frame_mask,
                   const float* __restrict__ window, const float* __restrict__ mel_w,
                   const float* __restrict__ melf_w, const int* __restrict__ mel_off,
                   const int* __restrict__ bases, const unsigned char* __restrict__ dft_matrix,
                   float* __restrict__ ws,
                   const __grid_constant__ Params p) {
  extern __shared__ __align__(128) float smem[];
  const int F = p.F, L = p.L, S = p.S, M = p.M, tile = p.tile;
  const int kind = p.feature_kind;
  const BfLayout lay = bf16_block_layout(p);
  const int b = blockIdx.y, tx = blockIdx.x, f0 = tx * tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Sample* row = audio + static_cast<size_t>(b) * p.T;  // the bf16x3 form takes no block launch (origin 0)
  const int steps = p.kp / kBfStep, chunks = p.npass * steps;
  const int abytes = p.gather ? tile * kBfAChunk : 0;  // A's part of a stage
  const int sbytes = lay.stage * 4;

  // the packed weights, the filters' offsets and the pass table (in
  // `bases`): staged, or read from device memory (bands_global), one
  // pointer a block
  if (kind != kSpectrogram && !p.bands_global) {
    float* w = smem + lay.w;
    float* wf = smem + lay.wf;
    for (int i = tid; i < p.nnz; i += kBfThreads) {
      w[i] = mel_w[i];
      if (kind == kSsc) wf[i] = melf_w[i];
    }
    int* mo = reinterpret_cast<int*>(smem + lay.moff);
    for (int i = tid; i <= M; i += kBfThreads) mo[i] = mel_off[i];
    int* pt = reinterpret_cast<int*>(smem + lay.ptab);
    const int words = p.npass + 1 + 4 * bases[p.npass];
    for (int i = tid; i < words; i += kBfThreads) pt[i] = bases[i];
  }
  const float* bw = p.bands_global ? mel_w : smem + lay.w;
  const float* bwf = p.bands_global ? melf_w : smem + lay.wf;
  const int* off = p.bands_global ? mel_off : reinterpret_cast<const int*>(smem + lay.moff);
  const int* pt = p.bands_global ? bases : reinterpret_cast<const int*>(smem + lay.ptab);

  // the row's length; under non-centered framing a tile that starts at or
  // past it holds only zeros and takes no product (its powers are 0)
  const long long len = max(0, min(lengths[b], p.T));
  const bool dft = p.center != kNoCenter || static_cast<long long>(f0) * S < len;
  const int nv = valid_frames(lengths[b], p);
  for (int i = tid; i < tile && f0 + i < F; i += kBfThreads) {
    frame_mask[static_cast<size_t>(b) * F + f0 + i] = f0 + i < nv ? 1.f : 0.f;
  }
  if (tx == 0 && tid == 0) n_valid[b] = nv;

  // the ring and its mbarriers; the matrix's first chunks go out now, A's
  // parts of them once A is written
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem + lay.ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
  uint64_t* empty = full + p.stages;
  const long long acc_floats = p.acc_global ? (static_cast<long long>(gridDim.y) * F * p.nacc + 31) / 32 * 32 : 0;
  unsigned char* a_tile =
      p.gather ? reinterpret_cast<unsigned char*>(ws + acc_floats) +
                     (static_cast<size_t>(b) * gridDim.x + tx) * steps * abytes
               : reinterpret_cast<unsigned char*>(smem + lay.a);
  if (dft && tid == kBfProducer) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kBfConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < imin(p.stages, chunks); ++c) {
      mbar_expect_tx(full + c, sbytes);
      bulk_copy(ring + c * sbytes, dft_matrix + static_cast<size_t>(c) * kBfStageBytes, kBfStageBytes, full + c);
    }
  }

  // 2b. each frame's mean and energies under kCond (zeros past F and in a
  //     tile that takes no product), a warp a frame; sample a < L of the
  //     tile's frame fl from device memory (staged_at)
  float* ef = smem + lay.ef;
  float* mu_t = smem + lay.mu;
  auto xs = [&](int fl, int a) -> float {
    return staged_at<kDither>(row, static_cast<long long>(f0 + fl) * S + a, len, p);
  };
  const bool wsum = kCond && p.energy_source == kWindowedFrame;
  for (int fl = warp; fl < tile; fl += kBfThreads / 32) {
    float mu = 0.f, e = 0.f;
    if (dft && f0 + fl < F) {  // warp-uniform
      if constexpr (kCond) {
        if (p.remove_dc) {
          float s = 0.f;
          for (int a = lane; a < L; a += 32) s += xs(fl, a);
          mu = warp_sum(s) / static_cast<float>(L);
        }
        if (p.energy_source == kRawFrame) {
          for (int a = lane; a < L; a += 32) {
            const float d = xs(fl, a) - mu;
            e += d * d;
          }
        }
        if (wsum) {
          for (int a = lane; a < L; a += 32) {
            const float d = xs(fl, a) - mu;
            const float v = (a == 0 ? d * p.frame_keep0 : d - p.frame_preemph * (xs(fl, a - 1) - mu)) * window[a];
            e += v * v;
          }
        }
        if (p.energy_source != kPspec) e = warp_sum(e);
      }
    }
    if (lane == 0) {
      ef[fl] = e;
      mu_t[fl] = mu;
    }
  }
  // the accumulators, frame after frame (kernels/frontend.py
  // bf16_accumulators): M filter sums and the energy; for ssc the M mel and
  // then the M melf sums; for a spectrogram the energy alone. In shared
  // memory, or (acc_global) in the tile's frames' rows of the workspace's
  // [B, F, nacc], which no other block touches. A filter's first piece
  // writes its sum there and each later one adds to it (0 + s is s, so no
  // accumulator is zeroed first); its last piece writes the output lane
  const int e_at = kind == kSpectrogram ? 0 : M;  // the energy's accumulator
  float* acc = p.acc_global ? ws + (static_cast<size_t>(b) * F + f0) * p.nacc : smem + lay.acc;
  __syncthreads();  // the means

  // 2a. A: 16-byte unit u of the tile's hi (and the same unit of its lo,
  //     tile x 32 bytes on) holds frame fl's conditioned samples k0 .. k0 + 7
  //     (unwindowed: the matrix carries the window; zero past Lk and in
  //     frames past F) as bf16, hi = rn(g) and lo = rn(g - hi)
  const int Lk = imin(L, p.n_fft);
  if (dft) {
    for (int u = tid; u < steps * 2 * tile; u += kBfThreads) {
      const int s = u / (2 * tile), v = u - s * 2 * tile;
      const int fl = (v >> 4) * 8 + (v & 7);
      const int k0 = s * kBfStep + (v & 8);
      const bool live = f0 + fl < F;
      const float mu = mu_t[fl];
      float x[9];  // x[j] = sample k0 - 1 + j
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const int a = k0 - 1 + j;
        x[j] = live && a >= 0 && a < Lk && (kCond || j > 0) ? xs(fl, a) : 0.f;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float g[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = 2 * q + c + 1, a = k0 + 2 * q + c;
          if constexpr (kCond) {
            const float d = x[j] - mu;
            g[c] = a == 0 ? d * p.frame_keep0 : d - p.frame_preemph * (x[j - 1] - mu);
          } else {
            g[c] = x[j];
          }
          g[c] = live && a < Lk ? g[c] : 0.f;
        }
        const __nv_bfloat16 h0 = __float2bfloat16_rn(g[0]), h1 = __float2bfloat16_rn(g[1]);
        hi[q] = bf16_pair(h0, h1);
        lo[q] = bf16_pair(__float2bfloat16_rn(g[0] - __bfloat162float(h0)),
                          __float2bfloat16_rn(g[1] - __bfloat162float(h1)));
      }
      unsigned char* dst = a_tile + static_cast<size_t>(s) * tile * kBfAChunk + v * 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + tile * kBfAChunk / 2) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    // written by the generic proxy, read next by the async one (the bulk
    // copies from the workspace, or wgmma from shared memory)
    asm volatile("fence.proxy.async;" ::: "memory");
  }
  __syncthreads();

  // 4p. the projection of one pass (bins [136 pass, 136 pass + nb)) from its
  //     power rows, items claimed a warp at a time from a counter reset at
  //     the pass's handoff: a spectrogram's bins (the log kind of
  //     each into its lane), then item (s, fl): segment s of the pass table
  //     (filter m's weights i0 <= i < i1, bins from k0 of the pass) summed
  //     over frame fl's row in packed order and added to the frame's
  //     accumulator of m (for ssc both sums; one segment a filter a pass, so
  //     no two items add to one accumulator and the pieces of a band over two
  //     passes add in pass order), or at the filter's last piece (i1 =
  //     off[m + 1]) the log kind (logmel), the sum (plp) or the centroid
  //     (ssc) of the whole written to its lane; item (ns, fl), but for ssc,
  //     adds the pass's powers in bin order to the energy. A warp takes 32
  //     frames of a segment; where the accumulators are in device memory,
  //     items along a frame's row, and past 4 x kBfTeam segments a pass 32
  //     segments over every frame (the pass table read once a tile, a
  //     frame's outputs side by side).
  const float* pw_rows = smem + lay.pw;
  int* claim = reinterpret_cast<int*>(smem + lay.bar) + 2 * 2 * p.stages;  // 4 floats past the mbarriers
  auto project = [&](int pass) {
    const int nb = imin(kBfPassBins, p.bins - pass * kBfPassBins);
    const int s0 = kind == kSpectrogram ? 0 : pt[pass];
    const int ns = kind == kSpectrogram ? 0 : pt[pass + 1] - s0;
    // frame fl's energy: the pass's powers in bin order
    auto energy = [&](int fl) {
      const float* pw = pw_rows + fl * kBfPowStride;
      float e = 0.f;
      for (int k = 0; k < nb; ++k) e += pw[k];
      float* a = acc + static_cast<size_t>(fl) * p.nacc + e_at;
      *a = pass == 0 ? e : *a + e;
    };
    // filter m's segment (weights i0 <= i < i1, bins from k0 of the pass;
    // a later piece of its band, its last) over frame fl's row
    auto segment = [&](int m, int i0, int i1, int k0, bool later, bool last, int fl) {
      const float* q = pw_rows + fl * kBfPowStride + k0 - i0;  // q[i]: weight i's power
      float sum = 0.f, sumf = 0.f;
      for (int k = i0; k < i1; ++k) {
        float v = q[k];
        if (kind == kSsc) {
          v = v <= 0.f ? p.eps : v;
          sumf += v * bwf[k];
        }
        sum += v * bw[k];
      }
      float* a = acc + static_cast<size_t>(fl) * p.nacc;
      if (later) {
        sum = a[m] + sum;
        if (kind == kSsc) sumf = a[M + m] + sumf;
      }
      if (last) {
        out[(static_cast<size_t>(b) * F + f0 + fl) * (M + 1) + m] =
            kind == kSsc ? __fdiv_rn(sumf, sum) : kind == kPlp ? sum : log_lane(sum, p);
      } else {
        a[m] = sum;
        if (kind == kSsc) a[M + m] = sumf;
      }
    };
    if (p.acc_global && kind != kSpectrogram && ns >= 4 * kBfTeam) {
      // thousands of segments: a warp a unit, 32 segments, a lane's read
      // once, over every frame of the tile (the lanes' outputs and
      // accumulators side by side in a frame's row), then the energy, 32
      // frames a unit
      const int chunks = (ns + 31) / 32;
      const int units = chunks + (kind == kSsc ? 0 : tile / 32);
      for (;;) {
        int u = 0;
        if (lane == 0) u = atomicAdd(claim, 1);
        u = __shfl_sync(0xffffffffu, u, 0);
        if (u >= units) break;
        if (u >= chunks) {
          const int fl = 32 * (u - chunks) + lane;
          if (f0 + fl < F) energy(fl);
        } else if (32 * u + lane < ns) {
          const int* sg = pt + p.npass + 1 + 4 * (s0 + 32 * u + lane);
          const int m = sg[0], i0 = sg[1], i1 = sg[2], k0 = sg[3];
          const bool later = i0 != off[m], last = i1 == off[m + 1];
          for (int fl = 0; fl < tile && f0 + fl < F; ++fl) segment(m, i0, i1, k0, later, last, fl);
        }
      }
      return;
    }
    // item (s, fl), 32 x kBfItems a claim, after a spectrogram's bins: a
    // warp's 32 frames of one segment, or (the accumulators in device
    // memory) its items along a frame's row; item (ns, fl) the energy
    const int nspec = kind == kSpectrogram ? tile * nb : 0;
    const int items = nspec + tile * (ns + (kind == kSsc ? 0 : 1));
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(claim, 32 * kBfItems);
      base = __shfl_sync(0xffffffffu, base, 0);
      if (base >= items) break;
#pragma unroll
      for (int u = 0; u < kBfItems; ++u) {
        const int i = base + 32 * u + lane;
        if (i >= items) break;
        if (i < nspec) {
          const int fl = i / nb, k = i - fl * nb;
          if (f0 + fl < F) {
            out[(static_cast<size_t>(b) * F + f0 + fl) * (M + 1) + pass * kBfPassBins + k] =
                log_lane(pw_rows[fl * kBfPowStride + k], p);
          }
          continue;
        }
        const int j = i - nspec, per = ns + (kind == kSsc ? 0 : 1);
        const int fl = p.acc_global ? j / per : j % tile, s = p.acc_global ? j - fl * per : j / tile;
        if (f0 + fl >= F) continue;
        if (s == ns) {
          energy(fl);
          continue;
        }
        const int* sg = pt + p.npass + 1 + 4 * (s0 + s);
        const int m = sg[0], i0 = sg[1], i1 = sg[2];
        segment(m, i0, i1, sg[3], i0 != off[m], i1 == off[m + 1], fl);
      }
    }
  };
  // 4e. the epilogue: each frame's lane M, the energy (0 for ssc), by the
  //     team's thread ti of kBfTeam (every filter's lane was written by its
  //     last piece, a spectrogram's bins pass by pass)
  auto epilogue = [&](int ti) {
    for (int fl = ti; fl < tile && f0 + fl < F; fl += kBfTeam) {
      const float e = acc[static_cast<size_t>(fl) * p.nacc + e_at];
      out[(static_cast<size_t>(b) * F + f0 + fl) * (M + 1) + M] =
          kind == kSsc ? 0.f : kCond && p.energy_source != kPspec ? fmaxf(ef[fl], p.eps) : e <= 0.f ? p.eps : e;
    }
  };

  if (warp < kBfConsumers / 32) {
    // 3b. the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kBfConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int rbase = 64 * (warp >> 2);  // the warpgroup's first frame
    const int r0 = rbase + 16 * (warp & 3) + g;
    float* rows = smem + lay.pw;
    // this thread's re/im of the pass in the re/im rows (row r, column
    // 8j + 2t + c of re0, 136 more of re1), where the sums of each
    // kBfPromote steps add up: the tensor cores' own accumulation drifts
    // with the sum's length, so each stretch starts from 0 and adds to the
    // rows in fp32
    auto row_at = [&](int j, int h) {
      return reinterpret_cast<float2*>(rows + (r0 + 8 * h) * kBfAccStride + 8 * j + 2 * t);
    };
    int c = 0;  // the ring's chunk: pass * steps + step
    for (int pass = 0; pass < p.npass; ++pass) {
      float re0[68], re1[68];  // bins [0, 68) and [68, 136) of the pass
#pragma unroll
      for (int i = 0; i < 68; ++i) re0[i] = re1[i] = 0.f;
      // the handoff of the last pass's power rows: take what is left of its
      // projection, then meet the projectors; before the rows are rewritten
      auto handoff = [&]() {
        if (pass > 0) {
          project(pass - 1);
          named_sync(kBarEmpty, kBfTeam);
        }
      };
      bool first = true;
      int held = -1;  // the stage the group in flight read
#pragma unroll 1
      for (int s = 0; s < steps; ++s, ++c) {
        const int slot = c % p.stages;
        const bool drain = s + 1 == steps || (s + 1) % kBfPromote == 0;
        if (dft) {
          mbar_wait(full + slot, (c / p.stages) & 1);
          __syncwarp();
          const unsigned char* st = ring + slot * sbytes;
          const unsigned char* at = p.gather ? st + kBfStageBytes : a_tile + static_cast<size_t>(s) * tile * kBfAChunk;
          const uint64_t ah = b_desc(at + rbase * (kBfAChunk / 2));
          const uint64_t al = b_desc(at + tile * (kBfAChunk / 2) + rbase * (kBfAChunk / 2));
          const uint64_t wh = b_desc(st), wl = b_desc(st + kBfPartBytes);
          const uint64_t second = (kBfGroups / 2) * 256 >> 4;  // columns [136, 272)
          wgmma_fence();
          fence_regs(re0);
          fence_regs(re1);
          wgmma_m64n136k16_ss(re0, ah, wh);
          wgmma_m64n136k16_ss(re1, ah, wh + second);
          wgmma_m64n136k16_ss(re0, al, wh);
          wgmma_m64n136k16_ss(re1, al, wh + second);
          wgmma_m64n136k16_ss(re0, ah, wl);
          wgmma_m64n136k16_ss(re1, ah, wl + second);
          wgmma_commit();
          if (drain) {
            wgmma_wait<0>();
          } else {
            wgmma_wait<1>();
          }
          fence_regs(re0);
          fence_regs(re1);
          if (held >= 0) mbar_arrive(empty + held);  // the group before has retired
          held = slot;
          if (drain) {
            mbar_arrive(empty + slot);
            held = -1;
          }
        }
        if ((s + 1) % kBfPromote == 0 && s + 1 < steps) {
          if (first) handoff();
#pragma unroll
          for (int j = 0; j < 17; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h;
              float2* rw = row_at(j, h);
              const float2 x = make_float2(re0[i], re0[i + 1]), y = make_float2(re1[i], re1[i + 1]);
              rw[0] = first ? x : make_float2(rw[0].x + x.x, rw[0].y + x.y);
              rw[kBfPassBins / 2] = first ? y : make_float2(rw[kBfPassBins / 2].x + y.x, rw[kBfPassBins / 2].y + y.y);
              re0[i] = re0[i + 1] = re1[i] = re1[i + 1] = 0.f;
            }
          }
          first = false;
        }
      }
      if (!first) {  // the earlier stretches' sums, before the rows take the powers
#pragma unroll
        for (int j = 0; j < 17; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h;
            const float2* rw = row_at(j, h);
            const float2 x = rw[0], y = rw[kBfPassBins / 2];
            re0[i] += x.x;
            re0[i + 1] += x.y;
            re1[i] += y.x;
            re1[i + 1] += y.y;
          }
        }
        named_sync(kBarConsumers, kBfConsumers);  // every re/im read before the powers go over them
      } else {
        handoff();
      }
      // |X|^2 of each bin from its (cosine, sine) column pair, in registers,
      // into its power row
      auto store = [&](const float (&d)[68], int k0) {
#pragma unroll
        for (int j = 0; j < 17; ++j) {
          const int k = k0 + 4 * j + t;
          if (pass * kBfPassBins + k >= p.bins) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float x = d[4 * j + 2 * h], y = d[4 * j + 2 * h + 1];
            rows[(r0 + 8 * h) * kBfPowStride + k] = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
          }
        }
      };
      store(re0, 0);
      store(re1, kBfPassBins / 2);
      if (tid == 0) *claim = 0;
      __threadfence_block();
      if (pass + 1 < p.npass) {
        named_arrive(kBarFull, kBfTeam);
      } else {
        named_sync(kBarFull, kBfTeam);
        project(pass);
        named_sync(kBarEnd, kBfTeam);
        epilogue(tid);
      }
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kBfOtherRegs));
    if (warp == kBfProducer / 32) {
      // 3p. the producer: the first stages' A, then every later stage
      if (lane == 0 && dft) {
        if (abytes) {
          for (int c = 0; c < imin(p.stages, chunks); ++c) {
            bulk_copy(ring + c * sbytes + kBfStageBytes, a_tile + static_cast<size_t>(c % steps) * abytes, abytes,
                      full + c);
          }
        }
        for (int c = p.stages; c < chunks; ++c) {
          const int slot = c % p.stages;
          mbar_wait(empty + slot, ((c / p.stages) & 1) ^ 1);
          mbar_expect_tx(full + slot, sbytes);
          bulk_copy(ring + slot * sbytes, dft_matrix + static_cast<size_t>(c) * kBfStageBytes, kBfStageBytes,
                    full + slot);
          if (abytes) {
            bulk_copy(ring + slot * sbytes + kBfStageBytes, a_tile + static_cast<size_t>(c % steps) * abytes,
                      abytes, full + slot);
          }
        }
      }
    } else {
      // 4p. the projectors: pass after pass as its power rows fill, the last
      //     one and the epilogue with the consumers
      for (int pass = 0; pass < p.npass; ++pass) {
        named_sync(kBarFull, kBfTeam);
        project(pass);
        if (pass + 1 < p.npass) {
          __threadfence_block();
          named_arrive(kBarEmpty, kBfTeam);
        }
      }
      named_sync(kBarEnd, kBfTeam);
      epilogue(tid - kBfThreads + kBfTeam);
    }
  }
}

// The cluster plan's team: the block's 256 threads at __syncthreads, its
// tables read from device memory by __ldg.
struct ClusterTeam {
  static constexpr bool kGlobal = true;
  int rank;
  __host__ __device__ static constexpr int size() { return kThreads; }
  __device__ void sync() const { __syncthreads(); }
};

// 3k. The cluster plan's local FFT: the rank's cl_n points by the Stockham
//     stages of the local FFT's tables, stage 0 loading point n by first(n)
//     into row d (0: r0, 1: r1), each later stage the row the one before
//     stored; with remote0 the cluster meets after stage 0 (its loads read
//     other ranks' rows, which their stage 1 rewrites), else the block.
//     Returns the index of the row that holds the rank's outputs. (Rows
//     are chosen by a select, never an array indexed at run time, which
//     would live in local memory.)
template <typename First>
__device__ inline int local_fft(First first, float2* r0, float2* r1, int d, const Params& p,
                                const float2* tw, const int* base, bool remote0) {
  const ClusterTeam team{static_cast<int>(threadIdx.x)};
  const int n = p.cl_n;
  int src = 1 - d, dst = d, ns = 1;
  for (int s = 0; s < p.nstages; ++s) {
    const int R = static_cast<int>((p.radices >> (4 * s)) & 15u);
    if (s == 0) {
      stage_of_radix<true>(R, first, nullptr, dst ? r1 : r0, n, 1, tw, base, team);
    } else {
      stage_of_radix<false>(R, first, src ? r1 : r0, dst ? r1 : r0, n, ns, tw, base, team);
      tw += (n / R) * (R - 1);
    }
    base += n / R;
    if (s == 0 && remote0) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
    src = dst;
    dst = 1 - dst;
    ns *= R;
  }
  return src;
}

// 3x. The exchange, the plan's one pass across the cluster: butterfly k1 <
//     cl_n loads Y_r[k1] from row y of every rank r, twists it by
//     e^{-2 pi i r k1 / n} (the host's table, at (r - 1) cl_n + k1), takes
//     the C-point DFT and stores output q, X[k1 + q cl_n], to row x of rank
//     q at k1. Once the cluster meets, rank q holds X[q cl_n, (q + 1) cl_n)
//     in order.
template <int C>
__device__ inline void exchange_at(int k1, const float2* y, float2* x, const float2* xtw, int n2) {
  cg::cluster_group cl = cg::this_cluster();
  float2 v[C];
#pragma unroll
  for (int r = 0; r < C; ++r) v[r] = cl.map_shared_rank(y, r)[pad(k1)];
#pragma unroll
  for (int r = 1; r < C; ++r) v[r] = cmul(v[r], __ldg(xtw + (r - 1) * n2 + k1));
  dft_small<C>(v);
#pragma unroll
  for (int q = 0; q < C; ++q) cl.map_shared_rank(x, q)[pad(k1)] = v[q];
}

__device__ inline void exchange(const float2* y, float2* x, const Params& p, const float2* xtw, int rank) {
  for (int k1 = rank * kThreads + threadIdx.x; k1 < p.cl_n; k1 += p.cluster * kThreads) {
    switch (p.cluster) {  // uniform
      case 2: exchange_at<2>(k1, y, x, xtw, p.cl_n); break;
      case 4: exchange_at<4>(k1, y, x, xtw, p.cl_n); break;
      default: exchange_at<8>(k1, y, x, xtw, p.cl_n); break;
    }
  }
}

// Entry g of an output the exchange spread over the cluster (rank g / n2,
// index g mod n2 of its row x).
__device__ inline float2 spread_at(const float2* x, int g, int n2) {
  const int r = g / n2;
  return cg::this_cluster().map_shared_rank(x, r)[pad(g - r * n2)];
}

// Power v of bin k into the row pw of the rank that holds it (k / pb, at k
// mod pb).
__device__ inline void put_power(float* pw, int k, int pb, float v) {
  const int r = k / pb;
  cg::this_cluster().map_shared_rank(pw, r)[k - r * pb] = v;
}

// The real split (real_split's arithmetic) of Z spread over the cluster
// (zat(k) = Z[k]), its pairs k <= H/2 cut over the cluster's threads, each
// power stored to the rank that holds its bin; returns this thread's share
// of the powers' sum.
template <typename Zat>
__device__ inline float cluster_split(Zat zat, float* pw, const float2* tw, int H, float pscale, int pb,
                                      int rank, int C) {
  float es = 0.f;
  for (int k = rank * kThreads + threadIdx.x; k <= H / 2; k += C * kThreads) {
    const float2 a = zat(k);
    const float2 c = zat(k == 0 ? 0 : H - k);
    const float er = 0.5f * (a.x + c.x);
    const float ei = 0.5f * (a.y - c.y);
    const float orr = 0.5f * (a.y + c.y);
    const float oi = -0.5f * (a.x - c.x);
    const float2 w = __ldg(tw + k);
    const float wr = orr * w.x - oi * w.y;
    const float wi = orr * w.y + oi * w.x;
    const float xr = er + wr, xi = ei + wi;
    const float px = (xr * xr + xi * xi) * pscale;
    put_power(pw, k, pb, px);
    es += px;
    if (2 * k != H) {
      const float yr = er - wr, yi = ei - wi;
      const float py = (yr * yr + yi * yi) * pscale;
      put_power(pw, H - k, pb, py);
      es += py;
    }
  }
  return es;
}

// |X[k]|^2 * pscale of an odd n_fft's Bluestein outputs spread over the
// cluster (zat(k) = X[k], k < bins), each to the rank that holds its bin.
template <typename Zat>
__device__ inline float cluster_power(Zat zat, float* pw, int bins, float pscale, int pb, int rank, int C) {
  float es = 0.f;
  for (int k = rank * kThreads + threadIdx.x; k < bins; k += C * kThreads) {
    const float2 x = zat(k);
    const float px = (x.x * x.x + x.y * x.y) * pscale;
    put_power(pw, k, pb, px);
    es += px;
  }
  return es;
}

// The cluster plan (see the header): a persistent grid of clusters of
// p.cluster blocks, cluster i taking frames i, i + clusters, ... of the
// batch one at a time, block rank r of a cluster holding 1/C of each of the
// frame's FFT rows, the power bins [r pb, (r + 1) pb) and the filter
// partials of its bins. p is a grid constant, read in place.
template <typename Sample, bool kDither, bool kCond>
__global__ void __launch_bounds__(kThreads, 1)
logmel_kernel_cluster(const Sample* __restrict__ audio, const int* __restrict__ lengths,
               float* __restrict__ out, int* __restrict__ n_valid, float* __restrict__ frame_mask,
               const float* __restrict__ window, const float* __restrict__ mel_w,
               const float* __restrict__ melf_w, const int* __restrict__ mel_off,
               const int* __restrict__ mel_meta, const float2* __restrict__ twiddle,
               const int* __restrict__ bases, const __grid_constant__ Params p) {
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int C = p.cluster, rank = static_cast<int>(cl.block_rank()), tid = threadIdx.x;
  const int M = p.M, kind = p.feature_kind, L = p.L, S = p.S, F = p.F;
  const int n2 = p.cl_n, pb = p.cl_pb, bins = p.bins;
  const ClusterLayout lay = cluster_layout(p);
  float2* const r0 = reinterpret_cast<float2*>(smem);
  float2* const r1 = reinterpret_cast<float2*>(smem + lay.row);
  auto rank_row = [&](int i) { return i ? r1 : r0; };  // the rank's rows, by a select
  float* part = smem + lay.part;
  float* fsum = smem + lay.sum;
  float* red = smem + lay.red;
  float* slot = smem + lay.slot;
  int* rng = reinterpret_cast<int*>(smem + lay.rng);
  const bool ssc = kind == kSsc, bands = kind != kSpectrogram;
  const int blo = rank * pb, bhi = imin(bins, blo + pb);  // this rank's power bins
  const ClusterTeam team{tid};

  // 4r. the filters whose bands touch each rank's bins, rng[2q] ..
  //     rng[2q + 1] (none where the first is past the second), from each
  //     filter's first and last bin: every block finds every rank's
  if (tid < 2 * C) rng[tid] = tid & 1 ? -1 : M;
  __syncthreads();
  if (bands) {
    for (int m = tid; m < M; m += kThreads) {
      const int lo = meta_bin(mel_meta[mel_off[m]]);
      const int hi = meta_bin(mel_meta[mel_off[m + 1] - 1]) + 1;
      for (int q = 0; q < C; ++q) {
        if (lo < imin(bins, (q + 1) * pb) && hi > q * pb) {
          atomicMin(rng + 2 * q, m);
          atomicMax(rng + 2 * q + 1, m);
        }
      }
    }
  }
  __syncthreads();
  // this rank's packed weights, all those of its filters, in chunks of c a
  // thread; the filter each chunk starts inside and the thread where it
  // began (chunk_filter's, from the rank's first weight)
  const int ma = rng[2 * rank], mb = rng[2 * rank + 1];
  const int i0 = ma <= mb ? mel_off[ma] : 0, i1 = ma <= mb ? mel_off[mb + 1] : 0;
  const int c = ((i1 - i0 + kThreads - 1) / kThreads) | 1;
  int from = -1, m0 = 0;
  if (i0 + tid * c < i1) {
    m0 = filter_of(mel_off, M, i0 + tid * c);
    if (mel_off[m0] < i0 + tid * c) from = (mel_off[m0] - i0) / c;
  }
  cl.sync();  // every block of the cluster runs before one reads another's memory

  const float2* tws = twiddle + p.nsplit;  // the local FFT's twists
  const float2* chirp = twiddle + p.chirp;
  const float2* filt = twiddle + p.filt;
  const float2* xtw = twiddle + p.cross;
  const int Lk = imin(L, p.n_fft);
  const bool wsum = kCond && p.energy_source == kWindowedFrame;
  const bool framed = p.center == kNoCenter;
  const int nclusters = gridDim.x / C;
  const long long frames = static_cast<long long>(p.batch) * F;
  for (long long w = blockIdx.x / C; w < frames; w += nclusters) {
    const int b = static_cast<int>(w / F), f = static_cast<int>(w - static_cast<long long>(b) * F);
    const Sample* row = audio + static_cast<size_t>(b) * p.T + p.origin;
    const long long len = max(0, min(lengths[b], p.T - p.origin));
    if (rank == 0 && tid == 0) {  // the count and the mask
      const int nv = valid_frames(lengths[b], p);
      frame_mask[static_cast<size_t>(b) * F + f] = f < nv ? 1.f : 0.f;
      if (f == 0) n_valid[b] = nv;
    }
    const long long tf = static_cast<long long>(f) * S;
    // 2g. the frame's sample a from device memory (staged_at)
    auto dev = [&](int a) -> float { return staged_at<kDither>(row, tf + a, len, p); };
    float es = 0.f, e = 0.f, mu = 0.f;
    int pwi = 0;  // the row that holds this rank's powers
    if (framed && tf >= len) {  // 2z
      float* pw = reinterpret_cast<float*>(r0);
      for (int k = tid; k < pb; k += kThreads) pw[k] = 0.f;
    } else {
      // 2. the conditioning's mean and raw energy as cluster sums, the
      //    frame's samples cut over the cluster's threads, the ranks'
      //    block sums added in rank order
      if constexpr (kCond) {
        if (p.remove_dc) {
          float sum = 0.f;
          for (int a = rank * kThreads + tid; a < L; a += C * kThreads) sum += dev(a);
          sum = group_sum(sum, red, team);
          if (tid == 0) slot[2] = sum;
          cl.sync();
          float t = cl.map_shared_rank(slot, 0)[2];
          for (int q = 1; q < C; ++q) t += cl.map_shared_rank(slot, q)[2];
          mu = t / static_cast<float>(L);
        }
        if (p.energy_source == kRawFrame) {
          for (int a = rank * kThreads + tid; a < L; a += C * kThreads) {
            const float d = dev(a) - mu;
            e += d * d;
          }
        }
      }
      // the conditioned, windowed sample a < Lk
      auto sample = [&](int a) -> float {
        float x = dev(a);
        if constexpr (kCond) {
          x -= mu;
          x = a == 0 ? x * p.frame_keep0 : x - p.frame_preemph * (dev(a - 1) - mu);
        }
        return x * __ldg(window + a);
      };
      float* pw;
      if (p.form == kBluestein) {
        // 3d. the Bluestein form: the forward FFT of point g = C n + rank
        //     (the chirped pair or sample), the exchange (A spread in order),
        //     the inverse's stage 0 loading conj(A[g]) filter[g] from the rank
        //     that holds it, its exchange (D spread in order), then c[k]
        //     conj(D[k]) into the split (even n_fft) or the powers (odd)
        const bool packed = (p.n_fft & 1) == 0;
        auto point = [&](int n) -> float2 {
          const int g = C * n + rank;
          if (g >= p.bq) return make_float2(0.f, 0.f);
          const int a = packed ? 2 * g : g;
          const float re = a < Lk ? sample(a) : 0.f;
          const float im = packed && a + 1 < Lk ? sample(a + 1) : 0.f;
          if (wsum) e += re * re + im * im;
          return cmul(make_float2(re, im), __ldg(chirp + g));
        };
        int yi = local_fft(point, r0, r1, 0, p, tws, bases, false);
        cl.sync();
        exchange(rank_row(yi), rank_row(1 - yi), p, xtw, rank);
        cl.sync();
        const float2* A = rank_row(1 - yi);
        const int P = p.fft_n, J = p.cl_j;
        auto spectrum = [&](int n) -> float2 {
          const int g = C * n + rank, r = n / J;
          const float2 x = cl.map_shared_rank(A, r)[pad(g - r * n2)];
          return cmul(make_float2(x.x, -x.y), __ldg(filt + (packed ? imin(g, P - g) : g)));
        };
        yi = local_fft(spectrum, r0, r1, yi, p, tws, bases, true);
        cl.sync();
        exchange(rank_row(yi), rank_row(1 - yi), p, xtw, rank);
        cl.sync();
        const float2* D = rank_row(1 - yi);
        pwi = yi;
        pw = reinterpret_cast<float*>(rank_row(pwi));
        auto zat = [&](int k) -> float2 {  // c[k] conj(D[k])
          const float2 d = spread_at(D, k, n2), cc = __ldg(chirp + k);
          return make_float2(cc.x * d.x + cc.y * d.y, cc.y * d.x - cc.x * d.y);
        };
        es = packed ? cluster_split(zat, pw, twiddle, p.half, p.pscale, pb, rank, C)
                    : cluster_power(zat, pw, bins, p.pscale, pb, rank, C);
      } else {
        // 3a. the Stockham form: the local FFT of point g = C n + rank, the
        //     windowed pair (y[2g], y[2g+1]); the exchange (Z spread in
        //     order); the real split, its partners Z[H - k] from the ranks
        //     that hold them
        auto point = [&](int n) -> float2 {
          const int a = 2 * (C * n + rank);
          const float re = a < Lk ? sample(a) : 0.f;
          const float im = a + 1 < Lk ? sample(a + 1) : 0.f;
          if (wsum) e += re * re + im * im;
          return make_float2(re, im);
        };
        const int yi = local_fft(point, r0, r1, 0, p, tws, bases, false);
        cl.sync();
        exchange(rank_row(yi), rank_row(1 - yi), p, xtw, rank);
        cl.sync();
        const float2* Z = rank_row(1 - yi);
        pwi = yi;
        pw = reinterpret_cast<float*>(rank_row(pwi));
        es = cluster_split([&](int k) { return spread_at(Z, k, n2); }, pw, twiddle, p.half, p.pscale, pb,
                           rank, C);
      }
      if (wsum) {  // the windowed energy of the samples past n_fft
        for (int a = Lk + rank * kThreads + tid; a < L; a += C * kThreads) {
          const float d = dev(a) - mu;
          const float x = (d - p.frame_preemph * (dev(a - 1) - mu)) * __ldg(window + a);
          e += x * x;
        }
      }
    }
    // the rank's sums in slots, then the cluster meets: every power stored
    es = group_sum(es, red, team);
    if constexpr (kCond) {
      if (p.energy_source != kPspec) e = group_sum(e, red, team);
    }
    if (tid == 0) {
      slot[0] = es;
      slot[1] = e;
    }
    cl.sync();
    float* o = out + (static_cast<size_t>(b) * F + f) * (M + 1);
    const float* pw = reinterpret_cast<const float*>(rank_row(pwi));
    if (rank == 0 && tid == 0) {  // lane M: the energy, the ranks' sums in rank order
      float te = cl.map_shared_rank(slot, 0)[0], tr = cl.map_shared_rank(slot, 0)[1];
      for (int q = 1; q < C; ++q) {
        te += cl.map_shared_rank(slot, q)[0];
        tr += cl.map_shared_rank(slot, q)[1];
      }
      o[M] = kind == kSsc ? 0.f : kCond && p.energy_source != kPspec ? fmaxf(tr, p.eps) : te <= 0.f ? p.eps : te;
    }
    if (!bands) {  // a spectrogram: the log kind of each of the rank's bins
      for (int k = blo + tid; k < bhi; k += kThreads) o[k] = log_lane(pw[k - blo], p);
    } else {
      // 4c. the rank's partial of each of its filters: write_frame's
      //     balanced sum over the weights [i0, i1), a weight whose bin
      //     another rank holds adding nothing, into fsum[m] (melf: fsum[M + m])
      float acc = 0.f, accf = 0.f, hacc = 0.f, haccf = 0.f;
      int held = -1;
      bool head = from >= 0;
      int filt_m = m0;
      const int j0 = i0 + tid * c, j1 = imin(j0 + c, i1);
      for (int i = j0; i < j1; i += kProjBatch) {
        int ev[kProjBatch];
        float q[kProjBatch], wv[kProjBatch], wfv[kProjBatch];
#pragma unroll
        for (int u = 0; u < kProjBatch; ++u) {
          const bool in = i + u < j1;
          ev[u] = in ? mel_meta[i + u] : 0;
          wv[u] = in ? mel_w[i + u] : 0.f;
          wfv[u] = in && ssc ? melf_w[i + u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kProjBatch; ++u) {
          const int k = meta_bin(ev[u]);
          q[u] = k >= blo && k < bhi ? pw[k - blo] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kProjBatch; ++u) {
          if (i + u >= j1) break;
          const int k = meta_bin(ev[u]);
          if (k >= blo && k < bhi) {
            float v = q[u];
            if (ssc) {
              v = v <= 0.f ? p.eps : v;
              accf += v * wfv[u];
            }
            acc += v * wv[u];
          }
          if (ev[u] < 0) {  // the last weight of filter filt_m
            if (head) {
              hacc = acc;
              haccf = accf;
              held = filt_m;
              head = false;
            } else {
              fsum[filt_m] = acc;
              if (ssc) fsum[M + filt_m] = accf;
            }
            acc = accf = 0.f;
            ++filt_m;
          }
        }
      }
      part[tid] = acc;
      if (ssc) part[kThreads + tid] = accf;
      __syncthreads();
      if (held >= 0) {
        float sm = part[from], sf = ssc ? part[kThreads + from] : 0.f;
        for (int l = from + 1; l < tid; ++l) {
          sm += part[l];
          if (ssc) sf += part[kThreads + l];
        }
        fsum[held] = sm + hacc;
        if (ssc) fsum[M + held] = sf + haccf;
      }
    }
    cl.sync();  // every rank's filter partials
    if (bands) {
      // 4m. filter m of the rank's share (m = rank 256 + thread, then on by
      //     C 256) completed from the partials of the ranks whose bins it
      //     touches, in rank order, then its log kind (or nothing for plp,
      //     or the centroid ratio)
      for (int m = rank * kThreads + tid; m < M; m += C * kThreads) {
        float sm = 0.f, sf = 0.f;
        bool any = false;
        for (int q = 0; q < C; ++q) {
          if (rng[2 * q] <= m && m <= rng[2 * q + 1]) {
            const float* fq = cl.map_shared_rank(fsum, q);
            sm = any ? sm + fq[m] : fq[m];
            if (ssc) sf = any ? sf + fq[M + m] : fq[M + m];
            any = true;
          }
        }
        o[m] = ssc ? __fdiv_rn(sf, sm) : kind == kPlp ? sm : log_lane(sm, p);
      }
    }
    cl.sync();  // the rows, slots and partials are rewritten by the next frame
  }
}

// The wide plan's epilogue of a filter's sums s (and SSC's melf sum sf), by
// feature kind and, for log-mel, log kind: log_lane's arithmetic on the
// rounded sum (ln_stab's add by __fadd_rn, so no product is fused into it),
// the PLP sum, or the SSC ratio, fixed at compile time.
template <int kKind, int kLog>
struct WideFinish {
  static constexpr bool kSsc = kKind == mfcc_frontend::kSsc;
  float eps;
  __device__ float operator()(float s, float sf) const {
    if constexpr (kKind == mfcc_frontend::kSsc) {
      return __fdiv_rn(sf, s);
    } else if constexpr (kKind == kPlp) {
      return s;
    } else if constexpr (kLog == kLnStab) {
      return logf(__fadd_rn(s, 1e-6f));
    } else if constexpr (kLog == kDb) {
      return 10.f * log10f(s <= 0.f ? eps : s);
    } else if constexpr (kLog == kLnFloor) {
      return logf(fmaxf(s, eps));
    } else if constexpr (kLog == kLog10Floor) {
      return log10f(fmaxf(s, eps));
    } else {
      return logf(s <= 0.f ? eps : s);
    }
  }
};

// 3w. The wide plan (see the header): one tile of p.tile frames of row
//     blockIdx.y a block. Stage 1: the block's p.groups groups take the
//     tile's frames g, g + groups, ... one at a time through their two rows
//     as the gather plans do (step 2g: the frame from device memory; the
//     conditioning's group sums; the Stockham or Bluestein stages, the
//     tables by __ldg), the powers into the frame's own power row and the
//     energy lane into en. Stage 2: thread t takes filters t, t + 256, ...,
//     reads each one's weights once, and for each frame of the tile sums them
//     in packed order from the power rows, takes the log kind (nothing for
//     PLP, the ratio for SSC) in registers and stores its lane once. p is a
//     grid constant, read in place.
template <typename Sample, bool kDither, bool kCond>
__global__ void __launch_bounds__(kThreads, 2)
logmel_kernel_wide(const Sample* __restrict__ audio, const int* __restrict__ lengths,
                   float* __restrict__ out, int* __restrict__ n_valid, float* __restrict__ frame_mask,
                   const float* __restrict__ window, const float* __restrict__ mel_w,
                   const float* __restrict__ melf_w, const int* __restrict__ mel_off,
                   const int* __restrict__ mel_meta, const float2* __restrict__ twiddle,
                   const int* __restrict__ bases, const __grid_constant__ Params p) {
  extern __shared__ __align__(128) float smem[];
  const WideLayout lay = wide_layout(p);
  const int F = p.F, M = p.M, kind = p.feature_kind;
  const int b = blockIdx.y, f0 = blockIdx.x * p.tile, nf = imin(p.tile, F - f0);
  const Sample* row = audio + static_cast<size_t>(b) * p.T + p.origin;  // x[0]; x[-1] under origin 1
  const long long len = max(0, min(lengths[b], p.T - p.origin));
  const bool framed = p.center == kNoCenter;
  float* pws = smem + lay.pw;
  float* en = smem + lay.en;
  float* red = smem + lay.red;

  // the row's valid frame count, the mask of the tile's frames, the count
  // from the row's first tile
  const int nv = valid_frames(lengths[b], p);
  for (int i = threadIdx.x; i < nf; i += kThreads) {
    frame_mask[static_cast<size_t>(b) * F + f0 + i] = f0 + i < nv ? 1.f : 0.f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) n_valid[b] = nv;

  // stage 1: the group's frames (group_frame, as the gather plans take
  // them: 2g, the conditioning, the FFT), its two rows staged, its tables
  // by __ldg, each frame's powers into its own power row, its energy lane
  // into en
  {
    const int gsize = kThreads / p.groups, group = threadIdx.x / gsize, rank = threadIdx.x % gsize;
    const GroupTeam<true> team{rank, gsize, 1 + group};
    float* rows = smem + group * 2 * lay.row;
    float2* ra = reinterpret_cast<float2*>(rows);
    float2* rb = reinterpret_cast<float2*>(rows + lay.row);
    for (int fl = group; fl < nf; fl += p.groups) {
      float* pw = pws + fl * p.pws;
      float es, e_frame;
      group_frame<kDither, kCond>(team, p, row, len, f0 + fl, framed, true, nullptr, window, window, ra, rb,
                                  twiddle, bases, red, pw, es, e_frame);
      if (rank == 0) en[fl] = energy_of<kCond>(p, es, e_frame);
      team.sync();  // the rows are rewritten by the group's next frame
    }
  }
  __syncthreads();  // every power row of the tile is whole

  // stage 2: the projection filter by filter, each lane stored once; the
  // epilogue (finish: the log kind, the PLP sum or the SSC ratio) chosen
  // once, so no loop branches on it. A filter of one weight is one rounded
  // product a frame; of more, its weights in packed order from 0 (read from
  // device memory each frame).
  float* o = out + (static_cast<size_t>(b) * F + f0) * (M + 1);
  const size_t ostride = static_cast<size_t>(M) + 1;
  const float eps = p.eps;
  auto sums = [&](auto finish, int m, int i0, const float* q, float& s, float& sf) {
    constexpr bool ssc = decltype(finish)::kSsc;
    for (int i = i0; i < __ldg(mel_off + m + 1); ++i) {
      float v = q[meta_bin(__ldg(mel_meta + i))];
      if (ssc) {
        v = v <= 0.f ? eps : v;
        sf += v * __ldg(melf_w + i);
      }
      s += v * __ldg(mel_w + i);
    }
  };
  // tiles of kWideChunkTile frames or more: the filters kWideChunk at a
  // time, thread t taking filters c0 + t + 256 k, k < kWideFilters, their
  // weights read once a chunk into registers (one weight: its bin, w, wf;
  // more: -1 - its first packed index); then frame after frame it stores
  // their lanes, so the block writes a frame's kWideChunk lanes, one run of
  // the row, before the next frame's
  auto chunked = [&](auto finish) {
    constexpr bool ssc = decltype(finish)::kSsc;
    for (int c0 = 0; c0 < M; c0 += kWideChunk) {
      int e[kWideFilters];
      float w[kWideFilters], wf[kWideFilters];
#pragma unroll
      for (int k = 0; k < kWideFilters; ++k) {
        const int m = c0 + threadIdx.x + k * kThreads;
        e[k] = 0;
        w[k] = wf[k] = 0.f;
        if (m < M) {
          const int i0 = __ldg(mel_off + m);
          if (__ldg(mel_off + m + 1) - i0 == 1) {
            e[k] = meta_bin(__ldg(mel_meta + i0));
            w[k] = __ldg(mel_w + i0);
            if (ssc) wf[k] = __ldg(melf_w + i0);
          } else {
            e[k] = -1 - i0;
          }
        }
      }
      for (int fl = 0; fl < nf; ++fl) {
        const float* q = pws + fl * p.pws;
        float* orow = o + fl * ostride + c0 + threadIdx.x;
#pragma unroll
        for (int k = 0; k < kWideFilters; ++k) {
          const int m = c0 + threadIdx.x + k * kThreads;
          if (m < M) {
            float s = 0.f, sf = 0.f;
            if (e[k] >= 0) {
              float v = q[e[k]];
              if (ssc) {
                v = v <= 0.f ? eps : v;
                sf = v * wf[k];
              }
              s = v * w[k];
            } else {
              sums(finish, m, -1 - e[k], q, s, sf);
            }
            __stcs(orow + k * kThreads, finish(s, sf));
          }
        }
      }
    }
  };
  // shorter tiles (the large FFTs', one block an SM): thread t takes filters
  // t, t + 256, ..., each one's weights read once, then its lane frame after
  // frame
  auto filter_major = [&](auto finish) {
    constexpr bool ssc = decltype(finish)::kSsc;
    for (int m = threadIdx.x; m < M; m += kThreads) {
      const int i0 = __ldg(mel_off + m);
      if (__ldg(mel_off + m + 1) - i0 == 1) {
        const float* q = pws + meta_bin(__ldg(mel_meta + i0));
        const float w = __ldg(mel_w + i0), wf = ssc ? __ldg(melf_w + i0) : 0.f;
#pragma unroll 4
        for (int fl = 0; fl < nf; ++fl) {
          float v = q[fl * p.pws], sf = 0.f;
          if (ssc) {
            v = v <= 0.f ? eps : v;
            sf = v * wf;
          }
          __stcs(o + fl * ostride + m, finish(v * w, sf));
        }
      } else {
        for (int fl = 0; fl < nf; ++fl) {
          float s = 0.f, sf = 0.f;
          sums(finish, m, i0, pws + fl * p.pws, s, sf);
          __stcs(o + fl * ostride + m, finish(s, sf));
        }
      }
    }
  };
  auto project = [&](auto finish) {
    if (p.tile >= kWideChunkTile) {
      chunked(finish);
    } else {
      filter_major(finish);
    }
  };
  if (kind == kSsc) {
    project(WideFinish<kSsc, 0>{eps});
  } else if (kind == kPlp) {
    project(WideFinish<kPlp, 0>{eps});
  } else {
    switch (p.log_kind) {
      case kLnStab: project(WideFinish<kLogmel, kLnStab>{eps}); break;
      case kDb: project(WideFinish<kLogmel, kDb>{eps}); break;
      case kLnFloor: project(WideFinish<kLogmel, kLnFloor>{eps}); break;
      case kLog10Floor: project(WideFinish<kLogmel, kLog10Floor>{eps}); break;
      default: project(WideFinish<kLogmel, kLn>{eps}); break;
    }
  }
  for (int fl = threadIdx.x; fl < nf; fl += kThreads) o[fl * ostride + M] = en[fl];
}

struct Args {
  const void* audio;
  const int* lengths;
  float* out;
  int* n_valid;
  float* frame_mask;
  const float *window, *mel_w, *melf_w;
  const int *mel_off, *mel_meta;
  const float* twiddle;
  const int* bases;
  const void* dft_matrix;
  const float* taps;
  float* rows_ws;  // "gather_rows": the workspace
  int B;
  Params p;
  Polyphase pp;
  cudaStream_t stream;
};

template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
size_t smem_of(const Params& p, const Polyphase& pp) {
  const Layout lay = kResample ? layout(p, resample_floats<Sample>(p, pp), pp.up * pp_stride(pp), true, false)
                               : layout(p, 0, 0, kDither, kBlock);
  return static_cast<size_t>(lay.total) * sizeof(float);
}

// The launch of one instantiation.
struct Launch {
  const Args& a;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
  cudaError_t run() const {
    const Params& p = a.p;
    if constexpr (kBf16 && kBlock) {
      const size_t bytes = static_cast<size_t>(bf16_block_layout(p).total) * sizeof(float);
      auto kernel = logmel_kernel_bf16<Sample, kDither, kCond>;
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      kernel<<<dim3((p.F + p.tile - 1) / p.tile, a.B), kBfThreads, bytes, a.stream>>>(
          static_cast<const Sample*>(a.audio), a.lengths, a.out, a.n_valid, a.frame_mask, a.window, a.mel_w,
          a.melf_w, a.mel_off, a.bases, static_cast<const unsigned char*>(a.dft_matrix), a.rows_ws, p);
      return cudaGetLastError();
    } else {
      const size_t bytes = smem_of<Sample, kResample, kDither, kCond, kBf16, kBlock>(p, a.pp);
      auto kernel = logmel_kernel<Sample, kResample, kDither, kCond, kBf16, kBlock>;
      cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      const dim3 grid = p.rows_global ? dim3(p.nslots) : dim3((p.F + p.tile - 1) / p.tile, a.B);
      kernel<<<grid, kThreads, bytes, a.stream>>>(
          static_cast<const Sample*>(a.audio), a.lengths, a.out, a.n_valid, a.frame_mask, a.window,
          a.mel_w, a.melf_w,
          a.mel_off, a.mel_meta, reinterpret_cast<const float2*>(a.twiddle), a.bases,
          static_cast<const unsigned char*>(a.dft_matrix), a.taps, a.rows_ws, p, a.pp);
      return cudaGetLastError();
    }
  }
};

// The card's view of one instantiation at `smem` bytes: registers and local
// (spilled) bytes a thread, and the blocks an SM holds.
struct Info {
  int smem;
  int* out;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
  cudaError_t run() const {
    if constexpr (kBf16 && kBlock) {
      return of(logmel_kernel_bf16<Sample, kDither, kCond>, kBfThreads);
    } else {
      return of(logmel_kernel<Sample, kResample, kDither, kCond, kBf16, kBlock>, kThreads);
    }
  }
  template <typename Kernel>
  cudaError_t of(Kernel kernel, int threads) const {
    cudaFuncAttributes attr = {};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, threads, smem);
    }
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return err;
  }
};

// The launch of the cluster plan's instantiation for a sample type and
// the dither and conditioning branches (dispatch's other template
// arguments are the plain form's, false): a persistent grid of p.nslots
// clusters of p.cluster blocks, by cudaLaunchKernelEx with the cluster
// dimension as a launch attribute.
struct ClusterLaunch {
  const Args& a;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
  cudaError_t run() const {
    const Params& p = a.p;
    const size_t bytes = static_cast<size_t>(cluster_layout(p).total) * sizeof(float);
    auto kernel = logmel_kernel_cluster<Sample, kDither, kCond>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.nslots * p.cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = a.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Sample*>(a.audio), a.lengths, a.out, a.n_valid,
                             a.frame_mask, a.window, a.mel_w, a.melf_w, a.mel_off, a.mel_meta,
                             reinterpret_cast<const float2*>(a.twiddle), a.bases, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

// The launch of the wide plan's instantiation for a sample type and the
// dither and conditioning branches (dispatch's other template arguments are
// the plain form's, false): a tile of p.tile frames a block.
struct WideLaunch {
  const Args& a;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
  cudaError_t run() const {
    const Params& p = a.p;
    const size_t bytes = static_cast<size_t>(wide_layout(p).total) * sizeof(float);
    auto kernel = logmel_kernel_wide<Sample, kDither, kCond>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((p.F + p.tile - 1) / p.tile, a.B), kThreads, bytes, a.stream>>>(
        static_cast<const Sample*>(a.audio), a.lengths, a.out, a.n_valid, a.frame_mask, a.window, a.mel_w,
        a.melf_w, a.mel_off, a.mel_meta, reinterpret_cast<const float2*>(a.twiddle), a.bases, p);
    return cudaGetLastError();
  }
};

// The card's view of the wide plan's instantiation at `smem` bytes.
struct WideInfo {
  Info info;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
  cudaError_t run() const {
    return info.of(logmel_kernel_wide<Sample, kDither, kCond>, kThreads);
  }
};

// The card's view of the cluster plan's instantiation at `smem` bytes and
// `cluster` blocks a cluster: registers and local bytes a thread, blocks an
// SM, and the clusters the card holds at once.
struct ClusterInfo {
  int smem, cluster;
  int* out;
  template <typename Sample, bool kResample, bool kDither, bool kCond, bool kBf16, bool kBlock>
  cudaError_t run() const {
    auto kernel = logmel_kernel_cluster<Sample, kDither, kCond>;
    cudaFuncAttributes attr = {};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, smem);
    }
    if (err == cudaSuccess) {
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = cluster;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cluster);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&out[3], kernel, &cfg);
    }
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.localSizeBytes);
    return err;
  }
};

// Picks the instantiation for the dither and conditioning branches.
template <typename Sample, bool kResample, bool kBf16, bool kBlock, typename Fn>
cudaError_t dispatch_sample(const Fn& fn, bool dither, bool cond) {
  if (dither) {
    return cond ? fn.template run<Sample, kResample, true, true, kBf16, kBlock>()
                : fn.template run<Sample, kResample, true, false, kBf16, kBlock>();
  }
  return cond ? fn.template run<Sample, kResample, false, true, kBf16, kBlock>()
              : fn.template run<Sample, kResample, false, false, kBf16, kBlock>();
}

// The plans with a kernel of their own (launch_of's kOwn): none (the ladder's
// logmel_kernel and the bf16x3 block plans'), the cluster plan, the wide plan.
enum { kLadderKernel = 0, kClusterKernel = 1, kWideKernel = 2 };

// One part of the instantiations (kernels/_build.py compiles each part of
// this file on its own, FRONTEND_PART = 1 .. 16, and the extern "C" entries
// alone as part 0, then links them): the launch and the card's view of the
// four instantiations of one sample type and one (fused resample, bf16x3,
// block plan) form, or (kOwn) of the cluster plan or the wide plan.
template <typename Sample, bool kResample, bool kBf16, bool kBlock, int kOwn>
cudaError_t launch_of(const Args& a, bool dth, bool cnd) {
  if constexpr (kOwn == kClusterKernel) {
    return dispatch_sample<Sample, false, false, false>(ClusterLaunch{a}, dth, cnd);
  } else if constexpr (kOwn == kWideKernel) {
    return dispatch_sample<Sample, false, false, false>(WideLaunch{a}, dth, cnd);
  } else {
    return dispatch_sample<Sample, kResample, kBf16, kBlock>(Launch{a}, dth, cnd);
  }
}
template <typename Sample, bool kResample, bool kBf16, bool kBlock, int kOwn>
cudaError_t info_of(int smem, int cluster, int* out, bool dth, bool cnd) {
  if constexpr (kOwn == kClusterKernel) {
    return dispatch_sample<Sample, false, false, false>(ClusterInfo{smem, cluster, out}, dth, cnd);
  } else if constexpr (kOwn == kWideKernel) {
    return dispatch_sample<Sample, false, false, false>(WideInfo{Info{smem, out}}, dth, cnd);
  } else {
    return dispatch_sample<Sample, kResample, kBf16, kBlock>(Info{smem, out}, dth, cnd);
  }
}

// The form of either sample type.
template <bool kResample, bool kBf16, bool kBlock, int kOwn = kLadderKernel>
cudaError_t launch_form(const Args& a, bool i16, bool dth, bool cnd) {
  return i16 ? launch_of<int16_t, kResample, kBf16, kBlock, kOwn>(a, dth, cnd)
             : launch_of<float, kResample, kBf16, kBlock, kOwn>(a, dth, cnd);
}
template <bool kResample, bool kBf16, bool kBlock, int kOwn = kLadderKernel>
cudaError_t info_form(int smem, int cluster, int* out, bool i16, bool dth, bool cnd) {
  return i16 ? info_of<int16_t, kResample, kBf16, kBlock, kOwn>(smem, cluster, out, dth, cnd)
             : info_of<float, kResample, kBf16, kBlock, kOwn>(smem, cluster, out, dth, cnd);
}

// The parts, in order (the sample type, then the form): built in parts,
// every part declares them all (extern template) and then instantiates its
// own; built as one file (no FRONTEND_PART) every use instantiates.
#define FRONTEND_PARTS(X)                                                              \
  X(int16_t, false, false, false, 0) X(float, false, false, false, 0) /* warp */        \
  X(int16_t, false, false, true, 0) X(float, false, false, true, 0)   /* block */       \
  X(int16_t, false, true, false, 0) X(float, false, true, false, 0)   /* bf16x3 */      \
  X(int16_t, false, true, true, 0) X(float, false, true, true, 0)     /* its plans */   \
  X(int16_t, true, false, false, 0) X(float, true, false, false, 0)   /* resample */    \
  X(int16_t, true, true, false, 0) X(float, true, true, false, 0)     /* it, bf16x3 */  \
  X(int16_t, false, false, false, 1) X(float, false, false, false, 1) /* cluster */     \
  X(int16_t, false, false, false, 2) X(float, false, false, false, 2) /* wide */
#define FRONTEND_DECLARE(S, r, b, k, c)                                              \
  extern template cudaError_t launch_of<S, r, b, k, c>(const Args&, bool, bool);    \
  extern template cudaError_t info_of<S, r, b, k, c>(int, int, int*, bool, bool);
#define FRONTEND_DEFINE(S, r, b, k, c)                                       \
  template cudaError_t launch_of<S, r, b, k, c>(const Args&, bool, bool);   \
  template cudaError_t info_of<S, r, b, k, c>(int, int, int*, bool, bool);
#ifdef FRONTEND_PART
FRONTEND_PARTS(FRONTEND_DECLARE)
#if FRONTEND_PART == 1
FRONTEND_DEFINE(int16_t, false, false, false, 0)
#elif FRONTEND_PART == 2
FRONTEND_DEFINE(float, false, false, false, 0)
#elif FRONTEND_PART == 3
FRONTEND_DEFINE(int16_t, false, false, true, 0)
#elif FRONTEND_PART == 4
FRONTEND_DEFINE(float, false, false, true, 0)
#elif FRONTEND_PART == 5
FRONTEND_DEFINE(int16_t, false, true, false, 0)
#elif FRONTEND_PART == 6
FRONTEND_DEFINE(float, false, true, false, 0)
#elif FRONTEND_PART == 7
FRONTEND_DEFINE(int16_t, false, true, true, 0)
#elif FRONTEND_PART == 8
FRONTEND_DEFINE(float, false, true, true, 0)
#elif FRONTEND_PART == 9
FRONTEND_DEFINE(int16_t, true, false, false, 0)
#elif FRONTEND_PART == 10
FRONTEND_DEFINE(float, true, false, false, 0)
#elif FRONTEND_PART == 11
FRONTEND_DEFINE(int16_t, true, true, false, 0)
#elif FRONTEND_PART == 12
FRONTEND_DEFINE(float, true, true, false, 0)
#elif FRONTEND_PART == 13
FRONTEND_DEFINE(int16_t, false, false, false, 1)
#elif FRONTEND_PART == 14
FRONTEND_DEFINE(float, false, false, false, 1)
#elif FRONTEND_PART == 15
FRONTEND_DEFINE(int16_t, false, false, false, 2)
#elif FRONTEND_PART == 16
FRONTEND_DEFINE(float, false, false, false, 2)
#endif
#endif

// The plain form's instantiations: bf16x3 (its staged plan, or its block
// plans), the block plan, or the warp plan.
inline cudaError_t launch_plain(const Args& a, bool is_int16, bool dither, bool cond, bool tensor,
                                bool block) {
  if (tensor) {
    return block ? launch_form<false, true, true>(a, is_int16, dither, cond)
                 : launch_form<false, true, false>(a, is_int16, dither, cond);
  }
  if (block) return launch_form<false, false, true>(a, is_int16, dither, cond);
  return launch_form<false, false, false>(a, is_int16, dither, cond);
}
inline cudaError_t info_plain(int smem, int* out, bool is_int16, bool dither, bool cond, bool tensor,
                              bool block) {
  if (tensor) {
    return block ? info_form<false, true, true>(smem, 0, out, is_int16, dither, cond)
                 : info_form<false, true, false>(smem, 0, out, is_int16, dither, cond);
  }
  if (block) return info_form<false, false, true>(smem, 0, out, is_int16, dither, cond);
  return info_form<false, false, false>(smem, 0, out, is_int16, dither, cond);
}

// The Stockham stages of n points (kernels/frontend.py radices(2n)): 8s,
// then one 4 or 2, then 3s and 5s, stage s in bits [4s, 4s + 4) of *rad;
// returns their count, or 0 when n < 2 or n has another prime factor.
inline int stockham_plan(int n, unsigned long long* rad) {
  if (n < 2) return 0;
  int h = n, ns = 0;
  unsigned long long r = 0;
  auto add = [&](int R) {
    r |= static_cast<unsigned long long>(R) << (4 * ns++);
    h /= R;
  };
  while (h % 8 == 0 && ns < kMaxStages) add(8);
  if (h % 4 == 0) {
    add(4);
  } else if (h % 2 == 0) {
    add(2);
  }
  while (h % 3 == 0 && ns < kMaxStages) add(3);
  while (h % 5 == 0 && ns < kMaxStages) add(5);
  if (h != 1 || ns > kMaxStages) return 0;
  *rad = r;
  return ns;
}

// p's Stockham FFT of n points: radices, the twiddle entries of its stages
// after the first (after the split's nsplit) and its output bases.
inline bool plan_stages(Params& p, int n) {
  p.fft_n = n;
  p.nstages = stockham_plan(n, &p.radices);
  if (p.nstages == 0) return false;
  int twists = 0;
  p.nbases = 0;
  for (int s = 0; s < p.nstages; ++s) {
    const int R = static_cast<int>((p.radices >> (4 * s)) & 15u);
    if (s > 0) twists += (n / R) * (R - 1);
    p.nbases += n / R;
  }
  p.ntw = p.nsplit + twists;
  return true;
}

// The block plan's ladder (kernels/frontend.py FFT_PLANS after "warp", and
// PLAN_TRAITS): whether a plan reads each frame (gather), the FFT tables,
// the packed bands and the FFT rows from device memory, and keeps the
// projection's sums there. The cluster plan is no row of it: a launch asks
// for it by its cluster size, and plan_cluster lays it out.
constexpr int kLadder[7][5] = {
    {0, 0, 0, 0, 0},  // block
    {0, 1, 0, 0, 0},  // block_global
    {1, 0, 0, 0, 0},  // gather
    {1, 1, 0, 0, 0},  // gather_global
    {1, 1, 1, 0, 0},  // gather_bands
    {1, 1, 1, 1, 0},  // gather_rows
    {1, 1, 1, 1, 1},  // gather_sums
};

// The cluster plan at C blocks a frame (kernels/frontend.py cluster_dims,
// cluster_smem): the form's FFT of fft_n points as C local FFTs of cl_n =
// fft_n / C points and one exchange, where fft_n is a multiple of C^2 and
// the layout fits the block; its table (kernels/frontend.py
// cluster_twiddles, cluster_bases) holds the split's entries, the local
// FFT's twists, the Bluestein chirp and filter spectrum, then the
// exchange's twists. False, p unchanged, where it does not apply.
inline bool plan_cluster(Params& p, int C) {
  const int n = p.fft_n;
  if (C < 2 || C > kMaxCluster || (C & (C - 1)) != 0 || n % (C * C) != 0) return false;
  Params q = p;
  q.cluster = C;
  q.cl_n = n / C;
  q.cl_j = n / (C * C);
  q.cl_pb = (q.bins + C - 1) / C;
  q.nstages = stockham_plan(q.cl_n, &q.radices);
  if (q.nstages == 0) return false;
  int twists = 0;
  q.nbases = 0;
  for (int s = 0; s < q.nstages; ++s) {
    const int R = static_cast<int>((q.radices >> (4 * s)) & 15u);
    if (s > 0) twists += (q.cl_n / R) * (R - 1);
    q.nbases += q.cl_n / R;
  }
  q.ntw = q.nsplit + twists;
  if (q.form == kBluestein) {
    q.chirp = q.ntw;
    q.filt = q.chirp + q.bq;
    q.ntw = q.filt + q.nfilt;
  }
  q.cross = q.ntw;
  q.ntw += (C - 1) * q.cl_n;
  if (cluster_layout(q).total * 4 > kSmemBudget) return false;
  q.block = q.gather = q.tables_global = q.bands_global = 1;
  q.rows_global = q.sums_global = 0;
  q.groups = 1;
  p = q;
  return true;
}

// The wide plan at `tile` frames a block (kernels/frontend.py wide_layout):
// the form's FFT in the first of 4, 2 and 1 groups whose layout fits the
// block beside the tile's power rows; each frame, the tables and the packed
// bands from device memory. False, p unchanged, where no group count fits
// or the feature kind has no weights (a spectrogram).
inline bool plan_wide(Params& p, int tile) {
  if (tile < 1 || p.feature_kind == kSpectrogram) return false;
  Params q = p;
  q.wide = q.block = q.gather = q.tables_global = q.bands_global = 1;
  q.rows_global = q.sums_global = 0;
  q.tile = tile;
  q.pws = align4(q.bins);
  for (q.groups = 4; q.groups >= 1; q.groups /= 2) {
    if (wide_layout(q).total * 4 <= kSmemBudget) {
      p = q;
      return true;
    }
  }
  return false;
}

// The block plan (kernels/frontend.py fft_layout without the cluster
// plan): the first plan of the ladder, at the first of 4, 2 and 1 groups
// (frames a block transforms at once), whose layout fits the block. The
// last, "gather_sums", fits at any n_fft, hop, frame length and filter
// count.
inline void plan_block(Params& p, bool wide) {
  p.block = 1;
  for (int plan = 0; plan < 7; ++plan) {
    for (int groups = 4; groups >= 1; groups /= 2) {
      p.gather = kLadder[plan][0];
      p.tables_global = kLadder[plan][1];
      p.bands_global = kLadder[plan][2];
      p.rows_global = kLadder[plan][3];
      p.sums_global = kLadder[plan][4];
      p.groups = groups;
      p.bchunk = ((p.nnz + kThreads / groups - 1) / (kThreads / groups)) | 1;
      if (layout(p, 0, 0, wide, true).total * 4 <= kSmemBudget) return;
    }
  }
}

// The DFT plan of p.n_fft for the wrapper's form (kernels/frontend.py
// kernel_form), as kernels/frontend.py radices, bluestein_dims,
// fft_twiddles, fft_plan and bf16_plan lay it out: the Stockham form only
// where it applies (an even n_fft >= 4 whose half factors into 8s, one 4 or
// 2, 3s and 5s), the Bluestein form with P the cheapest size >= Q + K - 1
// the Stockham stages take (fewest stages, then fewest points), bf16x3 at
// any n_fft (pp: the fused resample's, or null; int16: the rows' type); the
// projection's chunks. In the plain form (pp null) the Stockham and
// Bluestein forms take the block plan where the warp plan's layout is over
// the block, with the tables in device memory where the staged ones do not
// fit either, and the gather plans where the staged span and window do not
// (the packed bands, then the FFT rows, then the projection's sums, in
// device memory where they do not fit either); cluster > 0 takes the
// cluster plan at that many blocks a frame, wide_tile > 0 the wide plan at
// that many frames a block, which must apply. False when the wrapper's form
// disagrees, a plan asked for does not apply, or for n_fft < 2.
inline bool plan(Params& p, const Polyphase* pp, bool int16, int cluster, int wide_tile) {
  const int N = p.n_fft;
  if (N < 2) return false;
  p.half = N / 2;
  p.bins = N / 2 + 1;
  p.fft_n = p.nstages = 0;
  p.radices = 0;
  p.ntw = p.nbases = p.nsplit = p.bq = p.bk = p.chirp = p.filt = p.nfilt = 0;
  p.kp = p.nbp = p.npass = p.pws = p.stages = p.nacc = p.nptab = 0;
  p.block = p.tables_global = p.gather = p.bands_global = p.rows_global = p.sums_global = 0;
  p.acc_global = 0;
  p.cluster = p.cl_n = p.cl_j = p.cl_pb = p.cross = 0;
  p.wide = 0;
  p.groups = 1;
  p.tile = kTile;
  p.chunk = ((p.nnz + 31) / 32) | 1;
  p.bchunk = ((p.nnz + kThreads - 1) / kThreads) | 1;
  switch (p.form) {
    case kBf16x3:
      return plan_bf16(p, pp, int16);
    case kStockham:
      if (N % 2 != 0 || N < 4) return false;
      p.nsplit = N / 4 + 1;
      if (!plan_stages(p, p.half)) return false;
      break;
    case kBluestein: {
      const bool packed = N % 2 == 0;
      p.bq = packed ? p.half : N;
      p.bk = packed ? p.half : p.bins;
      p.nsplit = packed ? N / 4 + 1 : 0;
      const int lo = imax(p.bq + p.bk - 1, 2);
      int best = 0, best_stages = 0;
      unsigned long long r;
      for (int n = lo; n <= 2 * lo; ++n) {  // a power of two lies in [lo, 2 lo)
        const int st = stockham_plan(n, &r);
        if (st > 0 && (best == 0 || st < best_stages)) {
          best = n;
          best_stages = st;
        }
      }
      if (!plan_stages(p, best)) return false;
      p.chirp = p.ntw;
      p.filt = p.chirp + p.bq;
      p.nfilt = packed ? best / 2 + 1 : best;
      p.ntw = p.filt + p.nfilt;
      break;
    }
    default:
      return false;
  }
  const bool wide = p.dither > 0.f;  // the plain form's signal row under dither
  if (cluster > 0) return pp == nullptr && plan_cluster(p, cluster);
  if (wide_tile > 0) return pp == nullptr && plan_wide(p, wide_tile);
  if (pp == nullptr && layout(p, 0, 0, wide, false).total * 4 > kSmemBudget) plan_block(p, wide);
  return true;
}

inline bool bad_params(Params& p, int B, const float* melf_w, const int* bases, const Polyphase* pp,
                       bool int16, int cluster = 0, int wide = 0) {
  return p.L < 1 || p.S < 1 || p.M < 1 || B < 1 || p.F < 1 || !plan(p, pp, int16, cluster, wide) ||
         p.energy_source < kPspec || p.energy_source > kWindowedFrame ||
         p.log_kind < kLn || p.log_kind > kLog10Floor || p.feature_kind < kLogmel ||
         p.feature_kind > kSsc || (p.feature_kind == kSpectrogram && p.M != p.bins) ||
         (p.feature_kind != kSpectrogram && p.nnz < p.M) ||
         (p.feature_kind == kSsc && melf_w == nullptr) ||
         ((p.form == kStockham || p.form == kBluestein) && bases == nullptr) ||
         (p.form == kBf16x3 && p.block && p.nptab > 0 && bases == nullptr) ||
         p.center < kNoCenter || p.center > kCenterReflect || p.framing < kFramePad ||
         p.framing > kFrameCenterReflect;
}

}  // namespace mfcc_frontend

#if !defined(FRONTEND_PART) || FRONTEND_PART == 0
using namespace mfcc_frontend;

extern "C" {

// Launches the front-end on `stream`; returns cudaGetLastError() (0 = launched).
// audio [B, T] int16 (audio_is_int16 != 0) or float32; lengths [B] int32;
// out [B, F, M+1] float32; n_valid [B] int32 and frame_mask [B, F] float32
// receive ops/chain.py num_valid_frames and frame_mask of the lengths (framing
// 0 pad / 1 drop / 2 center / 3 center_reflect, drop_last != 0 for
// drop_last_frame); window [L] float32; the packed mel bands
// (kernels/frontend.py mel_packed; none read for a spectrogram): mel_w
// [n_packed] float32, melf_w [n_packed] float32 (ssc; may be null
// otherwise), mel_off [M+1] and mel_meta [n_packed] int32 (the weight's
// bin, the sign bit on each filter's last weight), every filter owning
// at least one weight; twiddle [n, 2] float32 and bases int32 as
// kernels/frontend.py fft_twiddles and stage_bases lay them out for
// dft_form 0 (Stockham), and for 2 (Bluestein) the split, the P-point
// stages' twists and bases, the chirp and the filter spectrum
// (kernels/frontend.py fft_twiddles, stage_bases), neither for 1 (bf16x3;
// bases may be null but for 0 and 2), read from device memory by the block
// plan's "block_global" (plan()); for 1 in a block plan of plan_bf16,
// bases is the pass table instead (kernels/frontend.py pass_table; null
// for a spectrogram); dft_matrix (dft_form 1 only, else null):
// the window-folded, scaled DFT's hi and lo parts in bf16, in ring order (kernels/frontend.py
// bf16_matrix: [pass][k16 step][hi | lo][8-column group][K half][column][k],
// column c of a pass the cosine (even c) or sine (odd c) of bin c/2; pscale
// is then unused: the matrix carries it).
// frame_offset is frame 0's first sample and center 0 none / 1 "center" /
// 2 "center_reflect". dither > 0 adds the contract noise (dither_seed =
// fmix32(cfg.dither_seed)); conditioning != 0 takes the frame-first branch
// (remove_dc, frame_preemph and frame_keep0 = 1 - frame_preemph,
// energy_source 0 pspec / 1 raw_frame / 2 windowed_frame); log_kind 0 ln /
// 1 ln_stab / 2 db / 3 ln_floor / 4 log10_floor; feature_kind 0 logmel /
// 1 plp / 2 spectrogram (M = n_fft/2+1) / 3 ssc. origin 0 frames each
// row from its sample 0; origin 1 is the block launch (streaming, see "The
// block launch" above): each row holds the pre-context sample x[-1] at 0
// and the block's signal from 1 (frame 0 starts at row sample 1), lengths[b]
// the samples from row sample 1 that hold signal (the counts and mask are
// of those lengths); it takes no dither, centered framing or bf16x3 form.
// Where plan() takes "gather_rows" or "gather_sums", rows_ws is the
// workspace of nslots slots of groups x 2 FFT rows, then for SSC under
// "gather_sums" nslots slots of groups x M melf sums (kernels/frontend.py
// rows_workspace: ws_floats floats, its contents any), one slot for each
// block of the persistent grid; where plan_bf16 takes a block plan past
// "pass", rows_ws is its workspace (bf16_workspace: under "gather_out" the
// accumulators [B, F, nacc], then each tile's A; ws_floats floats at
// least, its contents any); null for every other plan. cluster > 0 takes the cluster
// plan at that many blocks a frame (2, 4 or 8; refused where it does not
// apply), in a persistent grid of nslots clusters (the card's active
// clusters at most, kernels/frontend.py _active_clusters), its twiddle and
// bases the cluster plan's tables; 0 takes the ladder's other plans. wide >
// 0 takes the wide plan at that many frames a block (refused where it does
// not fit, and with cluster > 0), 0 another plan.
int mfcc_frontend_logmel(const void* audio, int audio_is_int16, const int* lengths,
                         float* out, int* n_valid, float* frame_mask, const float* window,
                         const float* mel_w,
                         const float* melf_w, const int* mel_off, const int* mel_meta,
                         const float* twiddle, const int* bases, const void* dft_matrix,
                         int B, int T, int F, int L, int S, int M,
                         int n_packed, int n_fft, int dft_form, int frame_offset, int center,
                         int framing, int drop_last, float scale, float preemph, float eps,
                         float pscale, float dither,
                         unsigned dither_seed, int conditioning, int remove_dc,
                         float frame_preemph, float frame_keep0, int energy_source,
                         int log_kind, int feature_kind, int origin, float* rows_ws,
                         int nslots, long long ws_floats, int cluster, int wide, void* stream) {
  Params p{T, F, L, S, M, n_packed, n_fft, dft_form, frame_offset, center, scale, preemph, eps,
           pscale, dither, dither_seed, remove_dc, energy_source, log_kind, frame_preemph,
           frame_keep0, feature_kind, framing, drop_last};
  p.origin = origin;
  if (cluster < 0 || wide < 0 || ((cluster > 0 || wide > 0) && dft_form == kBf16x3) || (cluster > 0 && wide > 0)) {
    return cudaErrorInvalidValue;
  }
  if (bad_params(p, B, melf_w, bases, nullptr, audio_is_int16 != 0, cluster, wide)) return cudaErrorInvalidValue;
  if (origin != 0 && (origin != 1 || T < 2 || dither > 0.f || center != kNoCenter ||
                      frame_offset != 0 || dft_form == kBf16x3)) {
    return cudaErrorInvalidValue;
  }
  const bool tensor = dft_form == kBf16x3;
  if (tensor && dft_matrix == nullptr) return cudaErrorInvalidValue;
  const long long bf16_ws = bf16_workspace(p, B);
  if (bf16_ws > 0 && (rows_ws == nullptr || ws_floats < bf16_ws)) return cudaErrorInvalidValue;
  if (p.cluster) {
    if (nslots < 1) return cudaErrorInvalidValue;
    p.nslots = nslots;
    p.batch = B;
  }
  if (p.rows_global) {
    const long long row = layout(p, 0, 0, dither > 0.f, true).row;
    const long long sums = p.sums_global && feature_kind == kSsc ? M : 0;
    if (rows_ws == nullptr || nslots < 1 ||
        ws_floats < static_cast<long long>(nslots) * p.groups * (2 * row + sums)) {
      return cudaErrorInvalidValue;
    }
    p.nslots = nslots;
    p.batch = B;
  }
  const Args a{audio, lengths, out, n_valid, frame_mask, window, mel_w, melf_w, mel_off,
               mel_meta, twiddle, bases, dft_matrix, nullptr, rows_ws, B, p,
               Polyphase{1, 1, 0, 0}, static_cast<cudaStream_t>(stream)};
  const bool i16 = audio_is_int16 != 0, dth = dither > 0.f, cnd = conditioning != 0;
  if (p.cluster) return launch_form<false, false, false, kClusterKernel>(a, i16, dth, cnd);
  if (p.wide) return launch_form<false, false, false, kWideKernel>(a, i16, dth, cnd);
  return launch_plain(a, i16, dth, cnd, tensor, p.block != 0);
}

// The same with the fused resample: audio [B, T] and lengths [B] at sr_in;
// taps [up, K] float32 (input_scale folded in); F frames of the resampled
// signal, ceil(T * up / down) samples long; n_valid from each row's output
// length ceil(lengths[b] * up / down). Dither keys on 16 kHz positions.
// dft_matrix as above for dft_form 1 (bf16x3), else null. No centered
// framing (kernels/frontend.py takes the split route for it: resample.cu,
// then mfcc_frontend_logmel).
int mfcc_frontend_logmel_resample(const void* audio, int audio_is_int16,
                                  const int* lengths, float* out, int* n_valid,
                                  float* frame_mask, const float* window,
                                  const float* mel_w, const float* melf_w, const int* mel_off,
                                  const int* mel_meta, const float* twiddle, const int* bases,
                                  const void* dft_matrix,
                                  const float* taps, int B, int T, int F, int L, int S, int M,
                                  int n_packed, int n_fft, int dft_form, int framing,
                                  int drop_last, int up, int down,
                                  int half_len, int K, float preemph, float eps, float pscale,
                                  float dither, unsigned dither_seed, int conditioning,
                                  int remove_dc, float frame_preemph, float frame_keep0,
                                  int energy_source, int log_kind, int feature_kind,
                                  void* stream) {
  Params p{T, F, L, S, M, n_packed, n_fft, dft_form, 0, kNoCenter, 1.f, preemph, eps, pscale,
           dither, dither_seed, remove_dc, energy_source, log_kind, frame_preemph, frame_keep0,
           feature_kind, framing, drop_last};
  const Polyphase pp{up, down, half_len, K};
  if (up < 1 || down < 1 || K < 1 || half_len < 10 * down || framing >= kFrameCenter ||
      bad_params(p, B, melf_w, bases, &pp, audio_is_int16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const bool tensor = dft_form == kBf16x3;
  if (tensor && dft_matrix == nullptr) return cudaErrorInvalidValue;
  p.aligned = (reinterpret_cast<uintptr_t>(audio) & 15) == 0;
  const Args a{audio, lengths, out, n_valid, frame_mask, window, mel_w, melf_w, mel_off,
               mel_meta, twiddle, bases, dft_matrix, taps, nullptr, B, p, pp,
               static_cast<cudaStream_t>(stream)};
  const bool i16 = audio_is_int16 != 0, dth = dither > 0.f, cnd = conditioning != 0;
  return tensor ? launch_form<true, true, false>(a, i16, dth, cnd) : launch_form<true, false, false>(a, i16, dth, cnd);
}

// Registers, local (spilled) bytes a thread and blocks an SM of the
// instantiation for (int16 rows, fused resample, dither, conditioning,
// bf16x3, the block plan) at smem_bytes of dynamic shared memory, into
// out[0..3). The fused resample has no block plan.
int mfcc_frontend_kernel_info(int audio_is_int16, int resample, int dither, int conditioning,
                              int bf16x3, int block, int smem_bytes, int* out) {
  const bool i16 = audio_is_int16 != 0, dth = dither != 0, cnd = conditioning != 0;
  if (!resample) return info_plain(smem_bytes, out, i16, dth, cnd, bf16x3 != 0, block != 0);
  if (block) return cudaErrorInvalidValue;
  return bf16x3 ? info_form<true, true, false>(smem_bytes, 0, out, i16, dth, cnd)
                : info_form<true, false, false>(smem_bytes, 0, out, i16, dth, cnd);
}

// Registers, local (spilled) bytes a thread, blocks an SM and the clusters
// the card holds at once of the cluster plan's instantiation for (int16
// rows, dither, conditioning) at `cluster` blocks a cluster and smem_bytes
// of dynamic shared memory a block, into out[0..4).
int mfcc_frontend_cluster_info(int audio_is_int16, int dither, int conditioning, int cluster,
                               int smem_bytes, int* out) {
  if (cluster < 2 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  return info_form<false, false, false, kClusterKernel>(smem_bytes, cluster, out, audio_is_int16 != 0,
                                                        dither != 0, conditioning != 0);
}

// Registers, local (spilled) bytes a thread and blocks an SM of the wide
// plan's instantiation for (int16 rows, dither, conditioning) at smem_bytes
// of dynamic shared memory a block, into out[0..3).
int mfcc_frontend_wide_info(int audio_is_int16, int dither, int conditioning, int smem_bytes, int* out) {
  return info_form<false, false, false, kWideKernel>(smem_bytes, 0, out, audio_is_int16 != 0, dither != 0,
                                                     conditioning != 0);
}

const char* mfcc_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
#endif  // !FRONTEND_PART || FRONTEND_PART == 0
