#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port, `xclip_tpu_torch`, on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

(--parent: an older checkout unpacked at DIR, e.g. by `git archive HEAD |
tar -x -C DIR`, whose library is built once and whose fp32 attention core
forward and backward (phases 6 and 12), fp32 K7 forward and backward
(phase 12) and fp32 product kernel (phase 19) are timed beside this
checkout's on the same operands; an entry point whose arguments differ
from this checkout's, as the attention ones did before they took a
dim_head, is not timed. Phase 27's model is first run by both checkouts
in turns, parent, this, this, parent, each run a process of its own, with
a profiled step: pairs/s, peak memory, device busy time and the kernels
that moved.)

Builds the port's CUDA kernels from `xclip_tpu_torch/csrc/` and drives its
main paths at the flagship width (dim 512, 6 + 6 layers, 257-row text,
64-patch vision, GEGLU inner 2048, bf16): inference through the forward
kernels K-FF and K-MEGA; the train step through the training kernels K1
(stored-GEGLU FF block) and K2 (stored attention megablock), forward and
backward; the memory-lean large-batch train step (b = 2048) through K3
(the attention megablock keeping only row statistics, recompute
backward), K-FF-s with the FF block's recompute backward, and K5 (the
streaming-LSE InfoNCE); the rotary causal-EOS text tower through K6 and
K7; and the two remaining FF routes, `ff_impl='fused'` through K8 (GEGLU +
inner LayerNorm) and XCLIP_FF_STORE=h through K1-h (the stored-h FF
block); every bf16 product of the FF blocks and the megablock runs on one
TMA-fed wgmma kernel and every fp32 one on one cp.async-fed FMA kernel,
both held alone in phase 19, and every LayerNorm over
rows (forward and backward) and GEGLU backward on the row kernels of
csrc/row_kernels.cuh, held alone in phase 20; a shape past the CUDA
kernels raises ValueError naming the limit (phase 21), and only the JAX
package's own gates send a flag to the plain path, with JAX's warning;
remat, grad_accum, valid=, checkpoint and resume, and dropout train the
flagship (phase 22); every objective of the JAX `CLIP` (MLM, SimSiam and
SimCLR, multiview, sim-reg, FILIP, downsampling) trains it (phase 23); the
data-parallel step runs in a one-rank NCCL group, and K5 at one rank of the
32k global batch (phase 24); the data pipeline tokenizes captions and
stages batches in pinned memory for the flagship train step (phase 25).
One line per phase; any failure exits non-zero, and nothing is caught.

  0 device   CUDA present; the card's name and power limit; TF32 off.
  1 build    nvcc builds the kernels; seconds taken.
  2 kernels  each kernel against its plain PyTorch version on the card, at
             the main path's shapes (b = 8), fp32 and bf16.
  3 golden   the tiny CLIP of tests/data/torch_port_golden.npz (outputs of
             the JAX package) through the port's kernels.
  4 main     the flagship answers requests: 4 batches of 64 pairs → scores,
             a 10-class × 2-template zero-shot classifier over 64 images,
             retrieval metrics; launch counts, finiteness, and agreement
             with the plain routes on the same weights (bf16 and fp32).
  5 times    CUDA-event medians: pairs/s at b = 256 on the kernel and plain
             routes; each kernel against its plain version at b = 256.
  6 train-kernels  K1 forward and both backward passes at the text (65,792
             rows) and vision (8,192 rows) shapes, K2 forward and backward
             at (256, 257, 512, 8 x 64), bf16, against their plain versions
             on the card: max_abs_err and tolerance of every output and
             gradient; CUDA-event times of kernel and plain version. Then
             the megablock's attention core alone (the step every
             megablock variant runs) at (256, 257, 3 x 512) with the text
             tower's key pads and with full-length captions, forward and
             backward, against its plain
             version element by element (phase 12's rule), two launches
             of each bit for bit equal, timed beside
             its plain version, scaled_dot_product_attention on the same
             q, k, v and mask, and its bound; the same for its fp32 FMA
             core at the text tower's shape and at one SimSiam pass's
             (256, 33), beside SDPA in fp32 (and, with --parent, the
             older checkout's forward and backward); its forward and
             backward at (8, 1024) and (4, 2048), up to the mask words'
             limit, the megablock's core and K6's causal with key
             pads, masked tiles and a dead element, against the plain
             version, two launches bit for bit, launched into NaN-filled
             memory.
  7 train-golden  one fp32 train step of the tiny CLIP of the golden file
             on the kernel routes against the JAX package's loss, gradients
             and updated parameters.
  8 train    the flagship train step at b = 256, bf16, AdamW lr 1e-4 (the
             rung-1 config of bench.py): 2 warm-up and 5 timed steps on the
             kernel routes, then on the plain routes from the same initial
             weights; pairs/s from CUDA events, peak memory, launch counts
             per step, finite losses, the first near ln 256, and the
             device's idle share and top kernels over one profiled step
             (after one more to warm the profiler up).
  9 lean-kernels  K-FF-s and the FF recompute backward at 65,792 and 8,192
             rows, K3 (stats and qkv modes, forward and recompute
             backward) at (256, 257, 512, 8 x 64) and (256, 32, 512), bf16,
             and K5 at (2048, 512) with DCL, fp32, against their plain
             versions on the card: max_abs_err and tolerance of every
             output and gradient (K5's backward also two launches bit for
             bit equal), CUDA-event times of kernel and plain (K5's
             forward too: two launches bit for bit equal);
             the megablock's core alone as in phase 6 at the vision
             tower's (256, 32) without pads.
 10 lean-golden  one fp32 train step of the golden file's tiny CLIP on the
             memory-lean routes against the JAX package's.
 11 lean-train  the flagship train step on the memory-lean routes
             (attn_impl='fused_recompute' in both towers, ff_impl='block',
             loss_impl='fused'), bf16, AdamW lr 1e-4: (a) b = 256 from
             phase 8's weights and inputs, 2 warm-up and 5 timed steps,
             beside phase 8's stored routes; (b) b = 2048, 2 warm-up and 3
             timed steps, pairs/s, peak memory, the idle share and top
             kernels over one profiled step; launch counts per step (the
             megablock core's among them), finite losses, the first near
             ln b; the bf16 product kernel's launches per step by
             instance against the count the step's chunks give; the
             LayerNorm forward rows, K5's kernels, the attention core's
             (forward, dq, dk/dv) and the ordered sums' by instance from
             the profile; the ordered sums' launches per step by regime
             (dg or split-k) and width, counted in the library, against
             the count each call site's chunks give.
 12 attn-kernels  K6 (whole-head attention on the fused qkv) forward and
             backward at (256, 256, 3 x 512) causal with key pads and at n =
             257 not causal, K7 (FlashAttention) forward and backward at
             b*h = 2048, n = 256 (the text tower) and (2, 8, 8192, 64)
             causal with key pads, and non-causal at the vision tower's 64
             and 32 (padded to 64) tokens, fp32 and bf16, and K7 in both
             dtypes at the text shape with whole masked key tiles and dead
             rows, launched into NaN-filled memory (inputs from a
             generator of its own), against their
             plain versions on the card element by element (bf16: two ulps
             of each element plus 3e-2 of its head row's RMS plus 1e-2 of
             the tensor's; fp32 and every lse: 1e-4 of the largest
             magnitude) and within 1e-3 relative Frobenius error each
             (K6 and the K7 backwards: two launches of each bit for bit
             equal);
             CUDA-event times of
             kernel, plain version and scaled_dot_product_attention
             (forward, backward, both) on the same q, k, v and mask, the
             kernel / SDPA ratio, and the bound (K7 at the vision shapes:
             kernel, bound, plain version and SDPA); K6 and K7 in fp32
             (the FMA kernels) timed likewise at the text shape, beside
             SDPA in fp32 and the 67 TFLOP/s fp32 bound (with --parent,
             the older checkout's fp32 K6 and K7 forwards and backwards
             beside them).
 13 rotary-golden  the rotary causal-EOS tiny CLIP of
             tests/data/torch_port_golden_rotary.npz on the K6 and K7
             routes, fp32: outputs and one train step against the JAX
             package's; K6's and K7's fp32 launches.
 14 rotary-serve  the flagship with text_rotary_pos_emb, text_causal_mask
             and text_eos_id 9999 answers b = 256 requests, bf16, on the K6
             route (attn_impl='fused', visual 'xla'), the K7 route
             (attn_impl='flash' in both towers) and the plain route:
             pairs/s, launch counts, latents against the plain route's.
 15 rotary-train  its train step at b = 256, bf16, AdamW lr 1e-4, on the K6
             and K7 routes from the same weights: 2 warm-up and 5 timed
             steps each, pairs/s, peak memory, launch counts per step, the
             idle share and top kernels over one profiled step, finite
             losses, the first near ln 256.
 16 ff-kernels  K8 (forward, backward) at (65,792, 2 x 2048) and (8,192,
             2 x 2048), and K1-h (forward, pass 1, pass 2) at 65,792 and
             8,192 rows of (512 -> 2 x 2048), fp32 and bf16, against their
             plain versions on the card: max_abs_err and tolerance of every
             output (fp32 1e-4 of its largest magnitude, bf16 two ulps of
             it); CUDA-event times of kernel and plain version, and bounds.
 17 ff-golden  the tiny CLIP of tests/data/torch_port_golden_ff.npz, fp32:
             ff_impl='fused' outputs and one train step, and one train step
             on the kernel routes with XCLIP_FF_STORE=h (set around that
             step only), against the JAX package's; K8 and K1-h must run.
 18 ff-routes  the flagship at b = 256, bf16, from phase 8's weights and
             inputs: serving on the K8 route (attn_impl='fused', visual
             'xla', ff_impl='fused': K-MEGA and K8) beside phase 5's kernel
             routes; training on the K8 route (K2 and K8) and on the
             stored-h route (phase 8's routes with XCLIP_FF_STORE=h: K2 and
             K1-h), 2 warm-up and 5 timed steps each: pairs/s, peak memory,
             launch counts per step, the idle share and top kernels over one
             profiled step, finite losses, the first within 0.1 of ln 256.
 19 products  the bf16 product kernel (csrc/gemm_sm90.cu, every bf16
             product of the FF blocks and the megablock) alone, class by
             class of the b = 2048 step (weight gradients, A.B^T and A.B to
             fp32, the GEGLU forward in its three epilogues, qkv, the FF
             out product with its residual), at the rows the step's calls
             take a chunk at and at 65,792 rows: against kernels/matmul.py's
             mm_plain (bf16 outputs at two ulps of their largest magnitude,
             fp32 at 1e-4 of it), CUDA-event times beside mm_plain and one
             PyTorch call (torch.mm with out_dtype=float32 where the output
             is fp32 and PyTorch has it, torch.addmm for the residual), the
             bound by FLOPs and by bytes, TFLOP/s. Phase 11 checks its
             launches per b = 2048 step by instance, counted in the library.
             Then the fp32 product kernel (csrc/gemm_f32.cu, every fp32
             product of the FF blocks and the megablock) class by class,
             every call at 8,448 rows (one SimSiam pass of phase 23) and
             at 65,792: against mm_plain at 1e-4 of each output's largest
             magnitude (every GEGLU epilogue), CUDA-event times beside
             mm_plain, torch.mm / addmm in fp32 (TF32 off) and, with
             --parent, the older checkout's kernel on the same operands;
             TFLOP/s and the share of the 67 TFLOP/s bound, each class
             under half its bound or slower than torch marked. Phase 23
             checks its launches per step by instance.
 20 rows     the LayerNorm-backward and GEGLU-backward row kernels
             (csrc/row_kernels.cuh) alone, mode by mode, at the rows and
             widths their callers give them: the recompute mode at the
             b = 2048 step's chunk rows and at 65,792 x 2048, the stored-h
             and K8 modes and the GEGLU-triple LayerNorm backward at 65,792
             x 2048, the plain LayerNorm backward at 65,792 x 512 (fp32 dy,
             residual, xn) and at a megablock chunk's rows (K3's out
             LayerNorm); fp32 and bf16 against kernels/rows.py's plain
             versions (bf16 outputs at two ulps of their largest
             magnitude, fp32 at 1e-4 of it), two launches bit for bit
             equal; CUDA-event times beside the plain version, the bytes
             bound and, for the LayerNorm backward, torch's
             native_layer_norm_backward (dx and dg, no residual add). Then
             the LayerNorm forward rows mode by mode (plain, stats,
             residual, in_copy, GEGLU) at their callers' shapes (65,792
             rows, 512 or 2048 wide, fp32 or bf16 rows) and at widths 7 to
             8,192, fp32 and bf16, against the plain version, two launches
             bit for bit equal, timed beside the plain version, the bytes
             bound and, for the plain mode, F.layer_norm (for the stats
             mode native_layer_norm, on the same fp32 or bf16 rows). Then
             the ordered sums
             (csrc/common.cuh: the slab kernel for the dg sums, the wide
             kernel for the split-k sums) at every call shape of the
             b = 2048 step (dg at 2048 and 512 wide from a 24,576-row
             chunk's 384 partials; the split-k sums of W_in, W_out, W_qkv
             and W_proj from 12; and the stored backwards' bf16 dg sums of
             1,028 partials), bit for bit against the plain ordered sum and
             between two launches, timed back to back in a CUDA graph,
             each call on its own copy of the partials, the copies
             together twice the L2 cache (every byte from HBM, as the
             bound counts it), beside their bytes bound and part.sum(0).
             No kernel of the last JSON line may take less than its
             bound. Phases 8, 11, 15 and 18 check the row kernels'
             launches per step by mode, and phase 11 the ordered sums' by
             regime and width, counted in the library.
 21 heads    small CLIPs (2 + 2 layers) whose text heads are 32 wide,
             under 'fused' (the megablock), 'fused' with rotary (K6) and
             'flash' (K7), 128 wide under 'flash', whose vision heads are
             4 x 80 wide under 'fused' (and 2 x 80, which the megablock
             takes padded to 96: 160 columns are off its 64-column grid),
             whose heads are 128 wide in both
             towers under 'fused', 'fused' with rotary and (fp32)
             'flash', whose text heads are 256 and vision heads 192 wide
             under 'fused', text heads 256 wide under 'fused' with
             rotary, and text heads 192 and vision heads 256 wide under
             'flash': the bf16 kernels take every head at its true width
             (a multiple of 8 up to 256, ⌈d / 64⌉ 64-column halves), the
             fp32 ones 64 and 128; served and trained one step on the
             card, every layer launching its kernel (counted by head
             width), no pad_heads call (the 2 x 80 case: two a
             megablock forward, 80 to 96) and no fallback warning, latents
             and the first loss against the plain routes'; the flagship
             with 2 x 256 heads in both towers, bf16, b = 256, served once
             and one train step through K2 and K1; the K-MEGA, K2, K6 and
             K7 wrappers at dim_head 32
             (fp32) against their plain versions at the true width (1e-4
             of the largest magnitude), K7's kernels at dim_head 128
             (bf16, phase 12's rule) timed beside their plain versions,
             their bound and SDPA, and K7 at 96 (padded to 128); the
             128-wide megablock core (256, 257, 4 x 128) and K6 (256,
             256, causal) in bf16 and fp32 and fp32 K7 (b*h 512, n 256),
             forward and backward against their plain versions (phase
             12's rule), two launches bit for bit, timed beside their
             plain versions, SDPA and their bounds; the fp32 kernels'
             blocks and warps an SM at 128 (16 warps, one block of two
             256-thread halves); K6 (256, 256, causal), the megablock core
             (256, 257) and K7 (b*h 512, n 256, causal), bf16, at heads of
             192 and 256 (2 heads in K6 and the core), forward and
             backward against their plain versions (phase 12's rule), two
             backward launches bit for bit, timed beside their plain
             versions, SDPA in bf16 and their bounds. Past the CUDA
             kernels (bf16 text dim_head 264 and fp32 192 under 'fused',
             dim 72 with FF inner 288 under 'block') the entry point
             raises ValueError naming the limit, and no plain route runs
             in the kernel's place.
 22 train-surface  the training surface on the flagship, bf16, from phase
             8's weights and inputs: (a) the stored route (K2, K1) at
             b = 256 under checkpoint_during_training with remat_policy
             None, 'dots' and 'wide': loss and every gradient bit for bit
             the step without remat (whose two launches must agree first),
             K2's and K1's forward launches twice a layer under None and
             'dots' and once under 'wide', 'dots' keeping no product in a
             text layer and two (qkv, out) in a vision layer; pairs/s and
             peak memory of all four; (b) the stored route at b = 2048
             under remat None (without remat it would not fit), 2 warm-up
             and 3 timed steps, beside phase 11's lean step; (c)
             grad_accum=2 at b = 256: its gradient bit for bit (g1 + g2) / 2
             of two 128-row backwards and its update the optimizer's on it;
             pairs/s; (d) valid= with the last 56 rows padding, in bf16
             and in fp32 on the same weights: the loss within 1e-5
             relative of the 200-row batch's, every gradient within 1e-3
             relative Frobenius in fp32 and within bf16's unit roundoff
             2^-8 in bf16, and JAX's refusal under loss_impl='fused'; (e)
             two steps, a checkpoint, a third step; a fresh model and
             optimizer loaded from it take the third step bit for bit
             (parameters, both moments, count, metrics), and the checkpoint
             loads on the CPU; (f) custom encoders with attention
             and FF dropout 0.1 on attn_impl='fused', ff_impl='block_stored',
             loss_impl='fused': JAX's two fallback warnings once each, K5
             launching and no megablock or FF block, every site's kept share
             1 - 0.1 within 4 sigma, remat None with the same seeds bit for
             bit; pairs/s. Every timed configuration also prints its idle
             share and device time over one profiled step.
 23 objectives  every objective on the flagship, bf16, seed 0, b = 256:
             (a) the reference README's full configuration (use_mlm,
             use_visual_ssl (SimSiam), DCL, the extra heads, sim-reg 0.1,
             loss_impl='fused') with a second caption and the port's
             default_augment of the batch as the augmented views, on the
             stored routes in both towers (K2, K1; K-MEGA and K-FF for the
             SimSiam targets' no_grad passes; K5 over the 2 x 2 view
             pairs): the first step's metrics in their ranges (CL and
             multiview near ln 255, MLM near ln 10000, SimSiam in [0, 8])
             and the BatchNorm statistics folded, the same step from the
             same weights and draws on the plain routes (under remat,
             which is bit for bit) within 0.05 or two bf16 ulps; 2 warm-up
             and 5 timed steps, pairs/s, peak memory, launches a step (K2
             and K1 30, K-MEGA and K-FF 12, K5 8 + 8; the fp32 product
             kernel's by instance, counted in the library, against the
             count the SimSiam passes' calls give), the idle share and
             top kernels of one profiled step with its fp32 products' and
             fp32 attention core's device ms; a target pass (fp32 and
             bf16 views) on the inference forwards bit for bit the
             training forwards'; (b) the same on the memory-lean routes
             (K3, K-FF-s, their backwards 30 a step); (c) SimCLR, one
             step, its statistics folded; (d) FILIP with the extra heads,
             dense and in blocks of 32 columns: losses within bf16
             rounding, the blocked peak below the dense; (e)
             downsample_image_embeds without patch dropout: (64, 256, 16)
             scores and a step; (f) grad_accum=2 with SimSiam: the
             statistics after the step bit for bit the second
             microbatch's fold alone; (g) the tiny CLIP with every
             objective that combines, fp32, on the kernel routes, one step
             against `tests/data/torch_port_golden_objectives.npz`
             (metrics 1e-5, gradients 1e-3 of the leaf's magnitude + 1e-5,
             parameters 1e-5, statistics 1e-6 + 1e-5 relative).
 24 data-parallel  (a) a world-1 NCCL group (a file store, no TCP): the
             flagship on the memory-lean routes at b = 256 from phase 8's
             weights and inputs, one step as make_train_step takes it
             (forward with axis_name, backward, the gradients' all-reduce,
             AdamW) under gather_impl 'sharded' and 'replicated': with
             loss_impl='fused' the loss, the metrics, every gradient and
             every parameter after it bit for bit the step without a group,
             K5's launches the same; with the dense loss the metrics within
             1e-6 relative and the gradients within bf16's unit roundoff
             (relative Frobenius); make_train_step(axis_name=group) timed
             beside the step without a group (pairs/s), K5 launching 2 + 2
             a step, and the gradient all-reduce's ms; (b) K5 at one rank
             of the 32k global batch, x (2048, 512) against y (32,768, 512),
             fp32 l2-normed, the rows × 14: forward and backward at row
             offsets 0, 14,336 and 30,720 (ranks 0, 7 and 15; the
             backward's column chunks are 8,192, so rank 15's diagonal lies
             in its last chunk), DCL off and on, against the plain version
             (lse 1e-4, gradients 1e-4 of their largest magnitude); CUDA-
             event times of kernel, plain version and logsumexp(x @ y.T)
             beside the bounds; (c) an emulated 8-rank split on the card:
             b = 2048 latents with the extra heads and DCL, the port's
             _fused_pair_losses on rows [256 r, 256 r + 256) against all
             2048 columns at row offset 256 r: the summed loss within 1e-6
             relative of the unsharded, the row gradients (in their rows)
             and the column gradients summed over r within 1e-4 relative
             Frobenius.
 25 data     the data pipeline (xclip_tpu_torch.data), without PIL: (a)
             the BPE merge loop built with g++ and in use, 4,096 seeded
             captions (5-60 words, some non-ASCII) the same ids through
             the native and Python loops, the 512 captions of
             tests/data/torch_port_golden_tokens.npz JAX's ids through
             both; captions/s of both, cold and warm; (b) TextImageLoader
             alone at b = 256, 4 thread workers, prefetch 2, on 2,048
             in-memory pairs (a caption each, one of 64 256-px fp32
             images): fp32, bf16, and pad_remainder on 2,000 pairs; every
             batch on the card bit for bit its host collate (tokens,
             images, valid, loader_state), every staging buffer pinned;
             pairs/s; the loader's copies of a staged batch re-enacted
             on the default stream and timed with CUDA events, and the
             producer's collate of a batch into a staging buffer from
             captions and from ids (ms a batch); (c) phase
             8's flagship with a 49,408-token vocabulary trained from the
             loader (bf16 images), 2 warm-up and 6 timed steps: launches
             per step K1 fwd/p1/p2 12, K2 fwd/bwd 6, the first step's
             loss and metrics bit for bit the same step on the host
             collate of its batch placed by .to('cuda'); pairs/s beside
             the same step on batches already on the card, each with the
             median idle share of three profiled steps.
 26 tensor-parallel
             the (data, model) mesh (xclip_tpu_torch.parallel): (a) phase
             8's flagship step (its weights, inputs and first draw; stored
             kernel routes, b = 256, bf16) through create_mesh((1, 1))
             over a world-1 NCCL group, shard_state, shard_batch and
             make_train_step(mesh=): the loss, grad_norm, every parameter
             and AdamW moment after the step bit for bit the step without
             a mesh, whose loss is phase 8's first; K1 and K2 launches
             equal; pairs/s of both steps timed in turns beside phase 8's,
             and the bytes of parameters and moments on the rank; (b)
             dryrun_multichip(1, device="cuda"): JAX's nine stages in a
             spawned NCCL rank, each loss finite, K5 launched in stage 6,
             K2 and K1 in stage 8, K3, K-FF-s and K5 in stage 9; and
             dryrun_multichip(2) refused with ValueError on one card;
             (c) the (1, 1) mesh's state after (a)'s step saved by the
             collective save_checkpoint over the NCCL group and restored
             into a fresh model with no mesh, parameters, AdamW moments
             and count bit for bit, and that model's save restored into a
             fresh model placed on the (1, 1) mesh, bit for bit.
 27 vit-h    a CLIP at the widths of OpenCLIP's ViT-H-14.json (vision
             1280, 16 heads of 80 at their true width, the megablock's
             qkv product 3,840 columns and no pad_heads call, 224-px
             images in 14-px patches; text 1024, 16 heads of 64, 77
             tokens, 49,408 ids; latents 1024; the repo's GEGLU FF at
             4x), bf16, at full
             depth (32 + 24 layers): serving at b = 64 (pairs/s, every
             layer's K-MEGA and K-FF launched), latents at b = 4 against
             the plain routes' (3e-2), and AdamW steps of K2 and K1 at
             b = 64 (pairs/s, peak memory, finite losses, launches per
             step), with no fallback warning; with --parent first the
             model by the older checkout and this one in turns (parent,
             this, this, parent, a process each): pairs/s, peak memory,
             a profiled step's device busy time and the kernels that
             moved, and each side's medians.
 28 examples the port's examples on the card: (a) the training example
             (xclip_tpu_torch.examples.train: dim 128, depth 2 + 2, 64-px
             images in 16-px patches, the 49,408-id vocabulary, bf16,
             TextImageLoader with 2 workers and bf16 images on the card,
             AdamW warmup-cosine) for 300 steps on the kernel routes
             (attn_impl 'fused' in both towers, ff_impl 'block_stored',
             loss_impl 'fused'): launches a step of K2, K1 and K5, none 0
             and no fallback warning; cl_loss at the first and last step,
             zero-shot top-1 over the 16 class prompts at init and after
             the run beside the JAX package's 0.816 on a TPU v5e
             (docs/RUN.md), pairs/s and seconds; the loss must fall, top-1
             rise, and the checkpoint restored into a fresh CLIP give the
             trained model's zero-shot logits bit for bit; (b) the
             zero-shot example (xclip_tpu_torch.examples.zero_shot): a
             (3, 128) classifier and a finite top-1.
The last lines are the kernels' JSON record (with each kernel's bound: the
larger of its bytes over the HBM rate and its FLOPs over the peak rate of
their type, NVIDIA H100 SXM data-sheet peaks at 700 W), the card line as
nvidia-smi prints it, and {"ok": true, "device": {...}}.
"""

import collections
import contextlib
import ctypes
import importlib.util
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.npz"
GOLDEN_ROTARY = GOLDEN.with_name("torch_port_golden_rotary.npz")
GOLDEN_FF = GOLDEN.with_name("torch_port_golden_ff.npz")

FLAGSHIP = dict(dim_text=512, dim_image=512, dim_latent=512,
                num_text_tokens=10000, text_enc_depth=6, text_seq_len=256,
                text_heads=8, visual_enc_depth=6, visual_heads=8,
                visual_image_size=256, visual_patch_size=32,
                visual_patch_dropout=0.5)
KERNEL_ROUTES = dict(attn_impl="fused", visual_attn_impl="xla",
                     ff_impl="block_stored")
PLAIN_ROUTES = dict(attn_impl="xla", visual_attn_impl="xla", ff_impl="xla")
# fp32: summation order only. bf16: two storage ulps at |out| < 8 (2^-5
# each); both sides round to bf16 at the same places.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 * 2.0 ** -5}
# kernel routes vs plain routes, latents (l2-normed, |v| <= 1): the routes
# round in other places (q pre-scaled, -finfo.max masks); fp32 agrees to
# summation order, bf16 to a few ulps of the 6-layer residual stream
LATENT_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
LEAN_ROUTES = dict(attn_impl="fused_recompute", ff_impl="block",
                   loss_impl="fused")
# the rotary, causal-EOS text tower (EOS the vocabulary's last id) and its
# two kernel routes: K6 in the text tower, or K7 in both towers
ROTARY = dict(text_rotary_pos_emb=True, text_causal_mask=True,
              text_eos_id=9999)
ROTARY_ROUTES = {
    "K6": dict(attn_impl="fused", visual_attn_impl="xla",
               ff_impl="block_stored"),
    "K7": dict(attn_impl="flash", visual_attn_impl=None,
               ff_impl="block_stored")}
# the GEGLU + inner-LayerNorm route (K8 in both towers beside the
# megablock); the stored-h FF block is KERNEL_ROUTES under STORED_H
K8_ROUTES = dict(attn_impl="fused", visual_attn_impl="xla", ff_impl="fused")
STORED_H = {"XCLIP_FF_STORE": "h"}
# NVIDIA H100 SXM data-sheet peaks (700 W): HBM bytes/s, dense bf16 tensor
# FLOP/s, fp32 FLOP/s outside the tensor cores
HBM, BF16_PEAK, FP32_PEAK = 3.35e12, 989e12, 67e12


def bound(nbytes, flops, peak=BF16_PEAK):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ff_cost(kind, rows, dim=512, inner=2048, it=2):
    """(bytes each input read and output written once, FLOPs) of one FF
    block call at `rows` rows; `it` the storage bytes per value."""
    w = (3 * dim * inner + dim + inner) * it
    x = rows * dim * it
    fwd = 6 * rows * dim * inner
    return {
        "fwd": (w + 2 * x, fwd),
        "fwd_stored": (w + 2 * x + 3 * rows * inner * it + 16 * rows, fwd),
        "fwd_stats": (w + 2 * x + 16 * rows, fwd),
        "p1": (w + 2 * x + 3 * rows * inner * it + 16 * rows + 2 * x
               + 4 * rows * inner * it + (dim + inner) * it, fwd),
        "p2": (2 * x + 3 * rows * inner * it + 3 * dim * inner * it, fwd),
        "bwd_recompute": (3 * x + 16 * rows + 2 * w, 16 * rows * dim * inner),
        # K1-h: h (rows x 2 inner) in place of the GEGLU triple; its pass 2
        # is K1's ("p2") on the operands pass 1 hands it
        "fwd_stored_h": (w + 2 * x + 2 * rows * inner * it + 16 * rows, fwd),
        "p1_h": (w + 2 * x + 2 * rows * inner * it + 16 * rows + 2 * x
                 + 4 * rows * inner * it + (dim + inner) * it, fwd),
    }[kind]


def geglu_ln_cost(kind, rows, inner=2048, it=2):
    """(bytes, fp32 operations) of one K8 call at `rows` rows: the forward
    reads h (rows x 2 inner) and g and writes out; the backward reads h, g
    and do and writes dh and dg. About 10 (forward) and 25 (backward)
    operations an inner element, erf and exp one each."""
    h, y, g = rows * 2 * inner * it, rows * inner * it, inner * it
    if kind == "fwd":
        return h + y + g, 10 * rows * inner
    return 2 * h + y + 2 * g, 25 * rows * inner


def mega_cost(kind, b, n, lengths, dim=512, heads=8, it=2):
    """(bytes, FLOPs) of one attention megablock call; the score products
    count each query against its valid keys only (`lengths`). The stored
    backward's five n x keys products are s (rebuilt), dp, dv, dq and dk;
    the recompute backward adds the qkv product, p·v and the out
    projection (s it shares with the backward). "_qkv": K3 keeping qkv
    (written by the forward, read by the backward in place of its qkv
    product)."""
    rows, hd = b * n, heads * 64
    w = (4 * dim * hd + 2 * dim) * it
    x = rows * dim * it
    qkv, small = 3 * rows * hd * it, rows * (8 * heads + 16)
    att = 2 * n * sum(lengths) * 64 * heads      # one n x keys product
    proj = 2 * rows * hd * dim
    fwd = 3 * proj + 2 * att + proj
    bwd = 2 * proj + 5 * att + 2 * 3 * proj
    io = w + 2 * x + b * n
    return {
        "fwd": (io, fwd),
        "fwd_stored": (io + qkv + rows * (hd + dim) * it + small, fwd),
        "fwd_stats": (io + small, fwd),
        "bwd_stored": (io + x + qkv * 2 + rows * (hd + dim) * it + small + w,
                       bwd),
        "bwd_recompute": (io + x + small + w, bwd + 3 * proj + att + proj),
        "fwd_stats_qkv": (io + small + qkv, fwd),
        "bwd_recompute_qkv": (io + x + small + w + qkv, bwd + att + proj),
    }[kind]


def lse_cost(kind, R, C, d):
    """(bytes, FLOPs) of K5 at fp32: the scores 2RCd, each backward
    product 2RCd more."""
    io = (R + C) * d * 4
    return {"fwd": (io + 4 * R, 2 * R * C * d),
            "bwd": (2 * io + 8 * R, 6 * R * C * d)}[kind]


def valid_pairs(lengths, n, causal):
    """(query, key) pairs whose key is valid, over batch elements whose
    first `length` keys are valid (every query row is computed)."""
    if causal:
        return sum(L * (L + 1) // 2 + (n - L) * L for L in lengths)
    return n * sum(lengths)


def used_keys(lengths, n):
    """Keys that some query reads, over batch elements whose first
    `length` keys are valid: the valid keys, or all n where the element
    has a dead row (no valid key: it is uniform over every key). With
    key 0 valid, causal rows are never dead."""
    return sum(L if L > 0 else n for L in lengths)


def core_cost(kind, rows_heads, keys_heads, pairs, mask_bytes, it=2,
              width=64):
    """(bytes, FLOPs) of one attention-core call over `rows_heads` (row,
    head) pairs of `width`, `keys_heads` (key, head) pairs that some
    query reads (`used_keys`) and `pairs` valid (query, key, head)
    triples: the forward reads q, the used k and v, writes out and the
    fp32 lse, and computes q·kᵀ and p·v over the valid pairs; the
    backward reads q, the used k and v, out, dout and lse, writes dq, dk
    and dv (zero for unused keys), and computes s, dp, dv, dq and dk."""
    e, e_kv = rows_heads * width * it, keys_heads * width * it
    if kind == "fwd":
        return (2 * e + 2 * e_kv + 4 * rows_heads + mask_bytes,
                4 * pairs * width)
    return (6 * e + 2 * e_kv + 4 * rows_heads + mask_bytes,
            10 * pairs * width)


def mega_core_cost(kind, rows_heads, keys_heads, pairs, mask_bytes, it=2,
                   width=64):
    """core_cost of the megablock's attention core, `it` bytes a stored
    value, heads of `width`: the forward writes the (m, l) pair (8 bytes a
    row and head) in place of lse; the backward reads q, attnout, the fp32
    row cotangent dattn (4 bytes an element) and the pair, and writes dq,
    dk and dv."""
    e, e_kv = rows_heads * width * it, keys_heads * width * it
    if kind == "fwd":
        return (2 * e + 2 * e_kv + 8 * rows_heads + mask_bytes,
                4 * pairs * width)
    return (5 * e + rows_heads * width * 4 + 2 * e_kv + 8 * rows_heads
            + mask_bytes, 10 * pairs * width)


def flash_cost(kind, bh, n, lengths, causal, it=2, width=64):
    """core_cost of K7 on (bh, n, width), the key mask repeated per head
    (`lengths` per bh row)."""
    return core_cost(kind, bh * n, used_keys(lengths, n),
                     valid_pairs(lengths, n, causal), bh * n, it, width)


def phase(n, name, msg):
    print(f"phase {n} {name}: {msg}", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=5, iters=3):
    """Median over `reps` of the mean CUDA-event time of `iters` calls, ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, calls=20):
    """The device's time per call of `fn`: its kernels' durations over
    `calls` calls from the profiler, summed, over `calls`, ms (no host
    launch cost, which CUDA events around kernels of a few µs measure
    instead; copies and sets not counted). The first profile only warms
    the profiler up; a profile that comes back without device events (it
    happens) is taken again, up to four times."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.end - e.time_range.start
                    for e in device_events(prof)
                    if not e.name.startswith(("Memcpy", "Memset")))
        if attempt > 0 and total > 0:
            return total / calls / 1e3
    fail("device_ms: the profiler saw no kernel in five profiles")


def backward_split(fn, calls=10):
    """(dq, dk/dv) device ms per call of an attention backward `fn`: its
    kernels' durations from the profiler, by name, over `calls` calls (the
    first profile only warms the profiler up, as device_ms's)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        parts = [0.0, 0.0]
        for e in device_events(prof):
            for i, key in enumerate(("bwd_dq", "bwd_dkv")):
                if key in e.name:
                    parts[i] += e.time_range.end - e.time_range.start
        if attempt > 0 and all(parts):
            return parts[0] / calls / 1e3, parts[1] / calls / 1e3
    fail("backward_split: the profiler saw no dq and dk/dv kernels")


def graph_ms(fn, calls, reps=5):
    """The device's time per call of `fn`, ms, from `calls` calls captured
    into one CUDA graph and replayed `reps` times back to back between two
    CUDA events: no gap on the host's launch between two kernels, in which
    the L2 cache would write back, unseen by the timing, what the kernels
    before left dirty."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def cold_sets(*tensors, cap=2 << 30):
    """Copies of `tensors` for timed calls to take in turn, a set a call
    (itertools.cycle), so that a call reads its inputs from HBM, as a bytes
    bound at the HBM rate counts them: each set was last touched before
    every other, and the copies of each tensor together fill at least
    twice the card's L2 cache (three sets at least; as many as `cap` bytes
    of sets allow for a small tensor beside a large one). (On an H100,
    inputs written just before the call and then evicted by a read of
    twice the cache stay partly in L2, and so do a running sum's three
    copies beside partials loaded evict-first.)"""
    nbytes = [t.numel() * t.element_size() for t in tensors]
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    sets = max(3, -(-2 * l2 // sum(nbytes)),
               min(-(-2 * l2 // min(nbytes)), cap // sum(nbytes)))
    return [tuple(t.clone() for t in tensors) for _ in range(sets)]


def rand(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def ff_inputs(gen, rows, dtype, dim=512, inner=2048):
    return (rand(gen, rows, dim, dtype=dtype),
            1 + rand(gen, dim, scale=0.1, dtype=dtype),
            rand(gen, dim, 2 * inner, scale=dim ** -0.5, dtype=dtype),
            1 + rand(gen, inner, scale=0.1, dtype=dtype),
            rand(gen, inner, dim, scale=inner ** -0.5, dtype=dtype))


def mega_inputs(gen, b, n, dim, heads, dtype, lengths):
    hd = heads * 64
    mask = torch.arange(n, device="cuda")[None] < torch.as_tensor(
        lengths, device="cuda")[:, None]
    return (rand(gen, b, n, dim, dtype=dtype),
            1 + rand(gen, dim, scale=0.1, dtype=dtype),
            rand(gen, dim, 3 * hd, scale=dim ** -0.5, dtype=dtype),
            rand(gen, hd, dim, scale=hd ** -0.5, dtype=dtype),
            1 + rand(gen, dim, scale=0.1, dtype=dtype), mask)


def compare(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    max_abs = err.max().item()
    max_rel = (err / want.float().abs().clamp_min(1e-3)).max().item()
    ok = bool(torch.isfinite(got).all()) and max_abs <= tol
    print(f"  {name}: max_abs_err {max_abs:.3e} (tol {tol:.1e}), "
          f"max_rel_err {max_rel:.3e}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return max_abs


def texts(gen, b, seq=256, vocab=10000):
    """Token ids with mixed caption lengths (pad id 0 after each)."""
    ids = torch.randint(1, vocab, (b, seq), generator=gen, device="cuda")
    lengths = torch.randint(4, seq + 1, (b,), generator=gen, device="cuda")
    return ids * (torch.arange(seq, device="cuda")[None] < lengths[:, None])


def eos_texts(gen, b, seq=256, eos=9999):
    """Captions of mixed lengths below `eos`, each ending in `eos`, then
    pads (0)."""
    ids = torch.randint(1, eos, (b, seq), generator=gen, device="cuda")
    lengths = torch.randint(4, seq + 1, (b,), generator=gen, device="cuda")
    pos = torch.arange(seq, device="cuda")[None]
    ids = torch.where(pos == lengths[:, None] - 1, eos, ids)
    return ids * (pos < lengths[:, None])


def key_mask(lengths, n):
    return torch.arange(n, device="cuda")[None] < torch.as_tensor(
        lengths, device="cuda")[:, None]


def sdpa_ms(q, k, v, mask, causal, scale, do):
    """CUDA-event times of torch's scaled_dot_product_attention on (b, h,
    n, d) q, k, v with one boolean mask of key pads and causality (no dead
    rows), or with no mask at all (`mask` None, not causal): (forward,
    backward, forward + backward) ms."""
    F = torch.nn.functional
    n = q.shape[2]
    m = None if mask is None else mask[:, None, None, :]
    if causal:
        m = m & torch.ones(n, n, dtype=torch.bool, device="cuda").tril()
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              scale=scale)

    with torch.no_grad():
        fwd_ms = cuda_ms(fwd)
    out = fwd()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), do,
                                                 retain_graph=True))
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do))
    return fwd_ms, bwd_ms, both_ms


# phase 12's bound on the relative Frobenius error of every K6 / K7 output
# (bf16 runs at ~3e-4, fp32 at ~1e-6): a bias spread over every element
# fails it, where each element alone stays within `attn_tol`
ATTN_FROB = 1e-3


def attn_tol(name, want, dtype):
    """Phase 12's tolerance of each element of `want`: fp32 outputs and
    every lse (fp32 in both dtypes) 1e-4 of the tensor's largest magnitude
    (summation order only). bf16 outputs: two bf16 ulps of the element
    plus 3e-2 of the RMS of its head row (its 64 features) plus 1e-2 of
    the tensor's RMS. Both sides round at the same places, but summation
    order can flip the bf16 rounding of a p or ds term, moving a sum by up
    to one ulp of that term (2^-7 of it); in a row with few valid keys one
    term is as large as the row, so a few flips reach ~2 % of the row."""
    w = want.float()
    if dtype == torch.float32 or name == "lse":
        return torch.full_like(w, 1e-4 * max(1.0, float(w.abs().max())))
    rows = w.reshape(-1, 64)
    ulp = torch.exp2(torch.floor(torch.log2(
        rows.abs().clamp_min(2.0 ** -126))) - 7)
    tol = (2 * ulp + 3e-2 * rows.pow(2).mean(-1, keepdim=True).sqrt()
           + 1e-2 * w.pow(2).mean().sqrt())
    return tol.reshape(w.shape)


def compare_elementwise(label, names, got, want, dtype):
    """Each output against its plain version element by element within
    `attn_tol`, and as a whole within `ATTN_FROB` relative Frobenius
    error; prints the max_abs_err, the worst err/tol and the relative
    Frobenius error; returns the largest max_abs_err."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        err = (g.float() - w.float()).abs()
        ratio = (err / attn_tol(name, w, dtype)).max().item()
        max_abs = err.max().item()
        frob = (err.norm() / w.float().norm().clamp_min(1e-30)).item()
        rule = ("1e-4 of max" if dtype == torch.float32 or name == "lse"
                else "2 ulps + 3e-2 row RMS + 1e-2 RMS")
        print(f"  {label} {name}: max_abs_err {max_abs:.3e}, worst err/tol "
              f"{ratio:.3f} (tol {rule} per element), rel Frobenius err "
              f"{frob:.2e} (tol {ATTN_FROB:.0e})", flush=True)
        if not (bool(torch.isfinite(g).all()) and ratio <= 1.0
                and frob <= ATTN_FROB):
            fail(f"{label} {name} disagrees with its plain version")
        worst = max(worst, max_abs)
    return worst


def parent_ms(parent, fn, kernel_ms):
    """", parent X ms (Y x the kernel)": `fn` timed on the older checkout's
    library `parent` (the wrappers bound to it) beside this checkout's
    `kernel_ms`."""
    from xclip_tpu_torch.kernels import _build
    try:
        with mock.patch.object(_build, "library", lambda: parent):
            ms = cuda_ms(fn)
    except ctypes.ArgumentError:
        return ", parent not timed (its entry point takes other arguments)"
    return f", parent {ms:.3f} ms ({ms / kernel_ms:.2f}x the kernel)"


def nan_fill(*specs):
    """Allocate NaN-filled tensors of the given (shape, dtype)s and free
    them: the caching allocator hands their blocks to the next tensors of
    those sizes, so an element a kernel leaves unwritten reads NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    blocks = [torch.full(shape, float("nan"), dtype=dtype, device="cuda")
              for shape, dtype in specs]
    torch.cuda.synchronize()
    del blocks


def f32_long_core(core, mega):
    """The fp32 core's forward and backward at long lengths, up to the mask
    words' 2048 (neither keeps a score row whole): the megablock's core
    (not causal) and K6's (causal) at
    (8, 1024, 8 x 64) and (4, 2048, 8 x 64) with key pads, whole masked
    64-key tiles, a leading masked tile and a dead element, the backward
    as in training (the forward's statistics from the plain version):
    each against its plain version (phase 12's rule), two launches bit for
    bit, every element written (the first launch into NaN-filled
    memory)."""
    g = torch.Generator(device="cuda").manual_seed(64)
    f32 = torch.float32
    for b, n in ((8, 1024), (4, 2048)):
        mask = key_mask(torch.randint(n // 2, n + 1, (b,), generator=g,
                                      device="cuda").tolist(), n)
        mask[0::4, 128:256] = False
        mask[1::4, :64] = False
        mask[-1] = False
        qkv = rand(g, b, n, 3 * 512)
        cot = rand(g, b, n, 512)
        for label, causal in (("megablock core", False), ("K6", True)):
            static = (8, 64, 0.125, causal, True)
            if causal:
                fwd_names, fwd_stats = ("out", "lse"), (b, n, 8)

                def run_fwd(plain=False):
                    fn = (core.attention_core_fwd_plain if plain
                          else core.attention_core_fwd)
                    return fn(qkv, mask, *static)

                def run_bwd(fwd, plain=False):
                    fn = (core.attention_core_bwd_plain if plain
                          else core.attention_core_bwd)
                    return fn(qkv, mask, *fwd, cot, *static)
            else:
                fwd_names, fwd_stats = ("attnout", "sm"), (b, n, 16)

                def run_fwd(plain=False):
                    fn = (mega.mega_core_fwd_plain if plain
                          else mega.mega_core_fwd)
                    return fn(qkv, mask, *static)

                def run_bwd(fwd, plain=False):
                    fn = (mega.mega_core_bwd_plain if plain
                          else mega.mega_core_bwd)
                    return fn(qkv, mask, cot, *fwd, *static)
            tag = (f"{label} fp32 ({b}, {n}, 3x512) 8x64 "
                   f"{'causal ' if causal else ''}key-pad, masked tiles, "
                   f"dead rows")
            nan_fill(((b, n, 512), f32), (fwd_stats, f32))
            got = run_fwd()
            if not all(map(torch.equal, got, run_fwd())):
                fail(f"{tag}: two forward launches differ")
            fwd = run_fwd(plain=True)
            compare_elementwise(tag, fwd_names, got, fwd, f32)
            del got
            nan_fill((tuple(qkv.shape), f32), ((b, n, 8), f32))
            got = run_bwd(fwd)
            if not torch.equal(got, run_bwd(fwd)):
                fail(f"{tag}: two backward launches differ")
            compare_elementwise(tag, ("dqkv",), (got,),
                                (run_bwd(fwd, plain=True),), f32)
            del got, fwd
        del qkv, cot, mask
        torch.cuda.empty_cache()


def attn_kernels(gen, core, flash, parent=None):
    """Phase 12: K6 and K7, forward and backward, against their plain
    versions on the card, fp32 and bf16, at the main path's shapes (K7 in
    the vision tower too: 64 tokens at inference, 32 kept patches in
    training, non-causal, padded to the kernel's tile; both dtypes at the
    text shape with whole masked key tiles and dead rows, into NaN-filled
    memory); times at the text tower's flagship shape, the long sequence
    and the vision shapes; with `parent` (an older checkout's library) the
    parent's fp32 K6 and K7 forwards and backwards on the same operands."""
    phase(12, "attn-kernels", "kernel vs plain version on the card")
    errs, ms, costs, lib, old = {}, {}, {}, {}, {}

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for b, n, causal in ((256, 256, True), (256, 257, False)):
            lengths = torch.randint(1, n + 1, (b,), generator=gen,
                                    device="cuda").tolist()
            mask = key_mask(lengths, n)
            qkv = rand(gen, b, n, 3 * 512, dtype=dtype)
            do = rand(gen, b, n, 512, dtype=dtype)
            static = (8, 64, 0.125, causal, True)
            label = (f"K6 {tag} ({b}, {n}, 3x512) 8x64 "
                     f"{'causal ' if causal else ''}key-pad")
            got = core.attention_core_fwd(qkv, mask, *static)
            if not all(map(torch.equal, got,
                           core.attention_core_fwd(qkv, mask, *static))):
                fail(f"{label}: two forward launches differ")
            e_fwd = compare_elementwise(
                label, ("out", "lse"), got,
                core.attention_core_fwd_plain(qkv, mask, *static), dtype)
            out, lse = core.attention_core_fwd_plain(qkv, mask, *static)
            got = core.attention_core_bwd(qkv, mask, out, lse, do, *static)
            if not torch.equal(got, core.attention_core_bwd(
                    qkv, mask, out, lse, do, *static)):
                fail(f"{label}: two backward launches differ")
            e_bwd = compare_elementwise(
                label, ("dqkv",), (got,),
                (core.attention_core_bwd_plain(qkv, mask, out, lse, do,
                                               *static),), dtype)
            del got
            if n == 256:
                # bf16 "k6"; fp32 (the FMA core) "k6_f32"
                key = "k6" if dtype == torch.bfloat16 else "k6_f32"
                errs.update({f"{key}_fwd": e_fwd, f"{key}_bwd": e_bwd})
                ms[f"{key}_fwd"] = (
                    cuda_ms(lambda: core.attention_core_fwd(qkv, mask,
                                                            *static)),
                    cuda_ms(lambda: core.attention_core_fwd_plain(
                        qkv, mask, *static)))
                ms[f"{key}_bwd"] = (
                    cuda_ms(lambda: core.attention_core_bwd(
                        qkv, mask, out, lse, do, *static)),
                    cuda_ms(lambda: core.attention_core_bwd_plain(
                        qkv, mask, out, lse, do, *static)))
                pairs = 8 * valid_pairs(lengths, n, causal)
                keys = 8 * used_keys(lengths, n)
                costs.update({f"{key}_{kind}": core_cost(
                    kind, b * n * 8, keys, pairs, b * n,
                    it=qkv.element_size()) for kind in ("fwd", "bwd")})
                q, k, v = (_heads_of(qkv, i) for i in range(3))
                lib[key] = sdpa_ms(q, k, v, mask, causal, 0.125,
                                   _heads_of(do, 0))
                if parent is not None and dtype == torch.float32:
                    old[f"{key}_fwd"] = parent_ms(
                        parent, lambda: core.attention_core_fwd(
                            qkv, mask, *static), ms[f"{key}_fwd"][0])
                    old[f"{key}_bwd"] = parent_ms(
                        parent, lambda: core.attention_core_bwd(
                            qkv, mask, out, lse, do, *static),
                        ms[f"{key}_bwd"][0])
            del qkv, do, out, lse
        # (b, h, n, causal, key pads): the text tower, the long sequence,
        # the vision tower at inference (64 tokens) and in training (32
        # kept patches, padded to the kernel's tile)
        for b, h, n, causal, pads in ((256, 8, 256, True, True),
                                      (2, 8, 8192, True, True),
                                      (256, 8, 64, False, False),
                                      (256, 8, 32, False, False)):
            lengths = (torch.randint(n // 2, n + 1, (b,), generator=gen,
                                     device="cuda").tolist() if pads
                       else [n] * b)
            mask = key_mask(lengths, n)
            q, k, v, do = (rand(gen, b, h, n, 64, dtype=dtype) for _ in
                           range(4))
            q = (q.float() * 0.125).to(dtype)
            flat, mask_bh = flash.pad_flat((q, k, v, do),
                                           mask if pads else None)
            bh, n_pad = mask_bh.shape
            label = (f"K7 {tag} ({b}, {h}, {n}, 64) "
                     + ("causal key-pad" if pads else
                        f"non-causal, padded to {n_pad}"))
            e_fwd = compare_elementwise(
                label, ("out", "lse"),
                flash.flash_attention_fwd(*flat[:3], mask_bh, causal),
                flash.flash_attention_fwd_plain(*flat[:3], mask_bh, causal),
                dtype)
            out, lse = flash.flash_attention_fwd_plain(*flat[:3], mask_bh,
                                                       causal)
            got = flash.flash_attention_bwd(*flat[:3], mask_bh, out, lse,
                                            flat[3], causal)
            if not all(map(torch.equal, got, flash.flash_attention_bwd(
                    *flat[:3], mask_bh, out, lse, flat[3], causal))):
                fail(f"{label}: two backward launches differ")
            e_bwd = compare_elementwise(
                label, ("dq", "dk", "dv"), got,
                flash.flash_attention_bwd_plain(*flat[:3], mask_bh, out, lse,
                                                flat[3], causal), dtype)
            del got
            if pads and (dtype == torch.bfloat16 or n == 256):
                key = ("k7_f32" if dtype == torch.float32 else
                       "k7" if n == 256 else "k7_long")
                errs.update({f"{key}_fwd": e_fwd, f"{key}_bwd": e_bwd})
                ms[f"{key}_fwd"] = (
                    cuda_ms(lambda: flash.flash_attention_fwd(
                        *flat[:3], mask_bh, causal)),
                    cuda_ms(lambda: flash.flash_attention_fwd_plain(
                        *flat[:3], mask_bh, causal)))
                ms[f"{key}_bwd"] = (
                    cuda_ms(lambda: flash.flash_attention_bwd(
                        *flat[:3], mask_bh, out, lse, flat[3], causal)),
                    cuda_ms(lambda: flash.flash_attention_bwd_plain(
                        *flat[:3], mask_bh, out, lse, flat[3], causal),
                        reps=3, iters=1))
                if parent is not None and dtype == torch.float32:
                    # the parent's C entry points, called by this
                    # checkout's wrappers (its fp32 dq kernel computes Δ)
                    old[f"{key}_fwd"] = parent_ms(
                        parent, lambda: flash.flash_attention_fwd(
                            *flat[:3], mask_bh, causal), ms[f"{key}_fwd"][0])
                    old[f"{key}_bwd"] = parent_ms(
                        parent, lambda: flash.flash_attention_bwd(
                            *flat[:3], mask_bh, out, lse, flat[3], causal),
                        ms[f"{key}_bwd"][0])
                lengths_bh = [L for L in lengths for _ in range(h)]
                it = q.element_size()
                costs.update({f"{key}_fwd": flash_cost("fwd", bh, n,
                                                       lengths_bh, causal, it),
                              f"{key}_bwd": flash_cost("bwd", bh, n,
                                                       lengths_bh, causal,
                                                       it)})
                lib[key] = sdpa_ms(q, k, v, mask, causal, 1.0, do)
            elif dtype == torch.bfloat16:
                errs.update({k: max(errs[k], e) for k, e in
                             (("k7_fwd", e_fwd), ("k7_bwd", e_bwd))})
                fwd_ms = cuda_ms(lambda: flash.flash_attention_fwd(
                    *flat[:3], mask_bh, False))
                bwd_ms = cuda_ms(lambda: flash.flash_attention_bwd(
                    *flat[:3], mask_bh, out, lse, flat[3], False))
                plain_fwd = cuda_ms(lambda: flash.flash_attention_fwd_plain(
                    *flat[:3], mask_bh, False))
                plain_bwd = cuda_ms(lambda: flash.flash_attention_bwd_plain(
                    *flat[:3], mask_bh, out, lse, flat[3], False))
                sdpa = sdpa_ms(q, k, v, mask, False, 1.0, do)
                lengths_bh = [n] * bh
                fwd_b, bwd_b = (bound(*flash_cost(kind, bh, n_pad, lengths_bh,
                                                  False))[0]
                                for kind in ("fwd", "bwd"))
                print(f"  K7 vision {n} tokens (b*h {bh}, n_pad {n_pad}): "
                      f"kernel forward {fwd_ms:.3f} ms (bound {fwd_b:.3f}, "
                      f"plain {plain_fwd:.3f}, sdpa {sdpa[0]:.3f} on the "
                      f"unpadded {n}), backward {bwd_ms:.3f} ms (bound "
                      f"{bwd_b:.3f}, plain {plain_bwd:.3f}, sdpa "
                      f"{sdpa[1]:.3f})", flush=True)
            del q, k, v, do, flat, out, lse
            torch.cuda.empty_cache()
    # K7 at the text shape with whole 64-key tiles masked between valid
    # keys, a leading masked tile (causal rows with no valid key) and one
    # element all masked (dead rows), which the kernels skip, in both
    # dtypes, each launched into NaN-filled memory and twice (bit for bit),
    # the backward fed the kernel forward's out and lse (a dead row's lse
    # is log 1e-30); inputs from a generator of their own, so the later
    # phases' draws stay put
    hgen = torch.Generator(device="cuda").manual_seed(12)
    b, h, n = 256, 8, 256
    mask = key_mask(torch.randint(n // 2, n + 1, (b,), generator=hgen,
                                  device="cuda").tolist(), n)
    mask[0::4, 64:128] = False
    mask[1::4, :64] = False
    mask[-1] = False
    draws = [rand(hgen, b, h, n, 64) for _ in range(4)]
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (t.to(dt) for t in draws)
        q = (q.float() * 0.125).to(dt)
        flat, mask_bh = flash.pad_flat((q, k, v, do), mask)
        tag = str(dt).split(".")[-1]
        label = f"K7 {tag} ({b}, {h}, {n}, 64) causal, masked tiles, dead rows"
        key = "k7" if dt == torch.bfloat16 else "k7_f32"
        nan_fill((tuple(flat[0].shape), dt),
                 (tuple(mask_bh.shape), torch.float32))
        got = flash.flash_attention_fwd(*flat[:3], mask_bh, True)
        if not all(map(torch.equal, got, flash.flash_attention_fwd(
                *flat[:3], mask_bh, True))):
            fail(f"{label}: two forward launches differ")
        e_fwd = compare_elementwise(
            label, ("out", "lse"), got,
            flash.flash_attention_fwd_plain(*flat[:3], mask_bh, True), dt)
        out, lse = got
        dead = slice(-h, None)   # the last element's heads
        if out[dead].float().abs().any() or float(
                (lse[dead] - math.log(1e-30)).abs().max()) > 1e-3:
            fail(f"{label}: a dead row's out is not 0 or its lse not "
                 "log 1e-30")
        nan_fill(*[(tuple(flat[0].shape), dt)] * 3,
                 (tuple(mask_bh.shape), torch.float32))
        got = flash.flash_attention_bwd(*flat[:3], mask_bh, out, lse, flat[3],
                                        True)
        if not all(map(torch.equal, got, flash.flash_attention_bwd(
                *flat[:3], mask_bh, out, lse, flat[3], True))):
            fail(f"{label}: two backward launches differ")
        e_bwd = compare_elementwise(
            label, ("dq", "dk", "dv"), got,
            flash.flash_attention_bwd_plain(*flat[:3], mask_bh, out, lse,
                                            flat[3], True), dt)
        errs.update({f"{key}_fwd": max(errs[f"{key}_fwd"], e_fwd),
                     f"{key}_bwd": max(errs[f"{key}_bwd"], e_bwd)})
        del q, k, v, do, flat, out, lse, got
    del draws
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for key in ms:
        b_ms, b_by = bound(*costs[key],
                           FP32_PEAK if "_f32" in key else BF16_PEAK)
        sdpa = lib[key.rsplit("_", 1)[0]]
        one = sdpa[0 if key.endswith("fwd") else 1]
        print(f"  {key}: kernel {ms[key][0]:.3f} ms ({ms[key][0] / one:.2f}x "
              f"sdpa), plain {ms[key][1]:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}), sdpa "
              f"{'forward' if key.endswith('fwd') else 'backward'} "
              f"{one:.3f} ms (forward + backward {sdpa[2]:.3f} ms)"
              + old.get(key, ""), flush=True)
    library = {key: lib[key.rsplit("_", 1)[0]][0 if key.endswith("fwd")
                                                 else 1] for key in ms}
    return errs, ms, costs, library


def _heads_of(t, i, heads=8):
    """The i-th 512-column third of a (b, n, ·) tensor as (b, heads, n,
    64) (a view)."""
    b, n, _ = t.shape
    return t[..., i * 512:(i + 1) * 512].reshape(b, n, heads, 64).transpose(
        1, 2)


# (key, record name, source, Pallas body replaced) of the training kernels
TRAIN_KERNELS = [
    ("k1_fwd", "K1 ff_block forward (stored GEGLU)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:303"),
    ("k1_p1", "K1 ff_block backward pass 1 (dx)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:625"),
    ("k1_p2", "K1 ff_block backward pass 2 (dW)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:841"),
    ("k2_fwd", "K2 attention_block forward (stored)",
     "xclip_tpu_torch/csrc/attention_megablock.cu",
     "xclip_tpu/kernels/attention_megablock.py:359"),
    ("k2_bwd", "K2 attention_block backward (stored)",
     "xclip_tpu_torch/csrc/attention_megablock.cu",
     "xclip_tpu/kernels/attention_megablock.py:396"),
]


def ulps2(want):
    """Two bf16 ulps at the largest magnitude of `want` (fp32 values of a
    bf16 computation: both sides round at the same places, and only
    summation order can flip a rounding)."""
    top = max(float(want.float().abs().max()), 2.0 ** -20)
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


def compare_all(label, got, want, names, dtype=torch.bfloat16):
    """Each output against its plain version: bf16 at two ulps of its own
    magnitude, fp32 (summation order only) at 1e-4 of it (at least 1e-4);
    returns the largest max_abs_err."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        tol = (1e-4 * max(1.0, float(w.float().abs().max()))
               if dtype == torch.float32 else ulps2(w))
        worst = max(worst, compare(f"{label} {name}", g, w, tol))
    return worst


def train_kernels(gen, ffb, mega):
    """Phase 6: K1 and K2, forward and backward, at the flagship shapes."""
    phase(6, "train-kernels", "bf16 kernel vs plain version on the card")
    dt = torch.bfloat16
    errs, ms = {}, {}
    for label, rows in (("text", 256 * 257), ("vision", 256 * 32)):
        args = ff_inputs(gen, rows, dt)
        tag = f"K1 ({rows}, 512) -> 2x2048"
        out, stored = ffb.ff_block_fwd_stored(*args)
        want_out, want_stored = ffb.ff_block_fwd_stored_plain(*args)
        e_fwd = compare_all(tag, (out, *stored), (want_out, *want_stored),
                            ("out", "prod", "gelu_b", "agdb", "stats"))
        do = rand(gen, rows, 512, dtype=dt)
        p1 = ffb.ff_block_bwd_p1(*args, do, want_stored)
        want_p1 = ffb.ff_block_bwd_p1_plain(*args, do, want_stored)
        e_p1 = compare_all(tag, (*p1[:4], *p1[4]),
                           (*want_p1[:4], *want_p1[4]),
                           ("dx", "dprod", "dg_pre", "dg_inner", "xn", "dh2",
                            "y2"))
        ops = want_p1[4]
        e_p2 = compare_all(tag, ffb.ff_block_bwd_p2(*ops, do),
                           ffb.ff_block_bwd_p2_plain(*ops, do),
                           ("dw_in", "dw_out"))
        del p1, want_p1, out, stored, want_out
        if label == "text":
            errs.update(k1_fwd=e_fwd, k1_p1=e_p1, k1_p2=e_p2)
            ms["k1_fwd"] = (cuda_ms(lambda: ffb.ff_block_fwd_stored(*args)),
                            cuda_ms(lambda: ffb.ff_block_fwd_stored_plain(
                                *args)))
            ms["k1_p1"] = (
                cuda_ms(lambda: ffb.ff_block_bwd_p1(*args, do, want_stored)),
                cuda_ms(lambda: ffb.ff_block_bwd_p1_plain(*args, do,
                                                          want_stored)))
            ms["k1_p2"] = (cuda_ms(lambda: ffb.ff_block_bwd_p2(*ops, do)),
                           cuda_ms(lambda: ffb.ff_block_bwd_p2_plain(*ops,
                                                                     do)))
        del ops, want_stored, args, do
        torch.cuda.empty_cache()
    b = 256
    lengths = torch.randint(1, 258, (b,), generator=gen,
                            device="cuda").tolist()
    args = mega_inputs(gen, b, 257, 512, 8, dt, lengths)
    static = (8, 64, 64 ** -0.5, False, True)
    tag = "K2 (256, 257, 512) 8x64 key-pad"
    out, stored = mega.attention_block_fwd_stored(*args, *static)
    want_out, want_stored = mega.attention_block_fwd_stored_plain(*args,
                                                                  *static)
    errs["k2_fwd"] = compare_all(
        tag, (out, *stored), (want_out, *want_stored),
        ("out", "qkv", "attnout", "proj", "sm", "ln_stats"))
    do = rand(gen, b, 257, 512, dtype=dt)
    errs["k2_bwd"] = compare_all(
        tag, mega.attention_block_bwd(*args, do, want_stored, *static),
        mega.attention_block_bwd_plain(*args, do, want_stored, *static),
        ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out", "dqkv"))
    del out, stored, want_out
    ms["k2_fwd"] = (
        cuda_ms(lambda: mega.attention_block_fwd_stored(*args, *static)),
        cuda_ms(lambda: mega.attention_block_fwd_stored_plain(*args,
                                                              *static)))
    ms["k2_bwd"] = (
        cuda_ms(lambda: mega.attention_block_bwd(*args, do, want_stored,
                                                 *static)),
        cuda_ms(lambda: mega.attention_block_bwd_plain(*args, do,
                                                       want_stored, *static)))
    torch.cuda.synchronize()
    for key, name, _, _ in TRAIN_KERNELS:
        print(f"  {name}: kernel {ms[key][0]:.3f} ms, plain "
              f"{ms[key][1]:.3f} ms", flush=True)
    del args, do, want_stored
    torch.cuda.empty_cache()
    rows = 256 * 257
    costs = {"k1_fwd": ff_cost("fwd_stored", rows), "k1_p1": ff_cost("p1", rows),
             "k1_p2": ff_cost("p2", rows),
             "k2_fwd": mega_cost("fwd_stored", b, 257, lengths),
             "k2_bwd": mega_cost("bwd_stored", b, 257, lengths)}
    return errs, ms, costs


# (key, record name, source, Pallas body replaced) of the megablock's
# attention core alone, timed at the text tower's shape in phase 6; its
# launches are those of the memory-lean b = 2048 step (phase 11), where K3
# runs it in both towers
CORE_KERNELS = [
    ("core_fwd", "megablock attention core forward (K-MEGA, K2, K3)",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_megablock.py:158"),
    ("core_bwd", "megablock attention core backward (dq, dk/dv; K2, K3)",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_megablock.py:396"),
]
# the fp32 attention kernels (FMAs), timed at the flagship shapes: (key,
# launch counter's key, record name, source, Pallas body replaced); the
# megablock's core at (256, 257) and at one SimSiam pass's (256, 33), K6
# and K7 at the text tower's shape
F32_CORE_KERNELS = [
    ("core_fwd", "attention core forward",
     "megablock attention core forward, fp32",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_megablock.py:158"),
    ("core_bwd", "attention core dq",
     "megablock attention core backward (dq, dk/dv), fp32",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_megablock.py:396"),
]
F32_ATTN_KERNELS = [
    ("k6_f32_fwd", "k6_fwd", "K6 attention_core forward, fp32",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_block.py:83"),
    ("k6_f32_bwd", "k6_bwd", "K6 attention_core backward (dq, dk/dv), fp32",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_block.py:117"),
    ("k7_f32_fwd", "k7_fwd",
     "K7 flash_attention forward, fp32: the core's K7 mode",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/flash_attention.py:66"),
    ("k7_f32_bwd", "k7_bwd",
     "K7 flash_attention backward (dq, dk/dv), fp32: the core's K7 mode",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/flash_attention.py:134"),
]


def mega_core_kernels(mega, label, b, n, lengths, maybe_dead, seed,
                      dt=torch.bfloat16, parent=None):
    """The megablock's attention core alone (`mega_core_fwd`, `_bwd`), in
    `dt` (bf16: the mma.sync kernels; fp32: the FMA core), 8 x 64 heads,
    non-causal, scale 64^-0.5, on random qkv and fp32 dattn (from a
    generator of its own, so the later phases' draws stay put) with
    `lengths` valid keys an element: against its plain version element by
    element, two launches of each bit for bit equal, timed beside its
    plain version, SDPA on the same q, k, v and mask, its bound and, with
    `parent` (an older checkout's library), the parent's forward and
    backward on the same operands. Returns (errs, ms, costs, library)
    keyed core_fwd, core_bwd."""
    cgen = torch.Generator(device="cuda").manual_seed(seed)
    scale = 64 ** -0.5
    peak = FP32_PEAK if dt == torch.float32 else BF16_PEAK
    mask = key_mask(lengths, n)
    qkv = rand(cgen, b, n, 3 * 512, dtype=dt)
    dattn = rand(cgen, b, n, 512)
    static = (8, 64, scale, False, maybe_dead)
    tag = (f"megablock core {str(dt).split('.')[-1]} ({b}, {n}, 3x512) 8x64 "
           f"{label}")
    want = mega.mega_core_fwd_plain(qkv, mask, *static)
    got = mega.mega_core_fwd(qkv, mask, *static)
    if not all(map(torch.equal, got, mega.mega_core_fwd(qkv, mask, *static))):
        fail(f"{tag}: two forward launches differ")
    errs = {"core_fwd": compare_elementwise(tag, ("attnout", "sm"), got,
                                            want, dt)}
    got = mega.mega_core_bwd(qkv, mask, dattn, *want, *static)
    if not torch.equal(got, mega.mega_core_bwd(qkv, mask, dattn, *want,
                                               *static)):
        fail(f"{tag}: two backward launches differ")
    errs["core_bwd"] = compare_elementwise(
        tag, ("dqkv",), (got,),
        (mega.mega_core_bwd_plain(qkv, mask, dattn, *want, *static),), dt)
    del got
    ms = {"core_fwd": (
        cuda_ms(lambda: mega.mega_core_fwd(qkv, mask, *static)),
        cuda_ms(lambda: mega.mega_core_fwd_plain(qkv, mask, *static))),
        "core_bwd": (
        cuda_ms(lambda: mega.mega_core_bwd(qkv, mask, dattn, *want,
                                           *static)),
        cuda_ms(lambda: mega.mega_core_bwd_plain(qkv, mask, dattn, *want,
                                                 *static)))}
    q, k, v = (_heads_of(qkv, i) for i in range(3))
    sdpa = sdpa_ms(q, k, v, mask, False, scale, _heads_of(dattn.to(dt), 0))
    pairs = 8 * valid_pairs(lengths, n, False)
    keys = 8 * used_keys(lengths, n)
    costs = {f"core_{kind}": mega_core_cost(kind, b * n * 8, keys, pairs,
                                            b * n, qkv.element_size())
             for kind in ("fwd", "bwd")}
    library = {"core_fwd": sdpa[0], "core_bwd": sdpa[1]}
    old = {}
    if parent is not None:
        old["core_fwd"] = parent_ms(parent, lambda: mega.mega_core_fwd(
            qkv, mask, *static), ms["core_fwd"][0])
        old["core_bwd"] = parent_ms(parent, lambda: mega.mega_core_bwd(
            qkv, mask, dattn, *want, *static), ms["core_bwd"][0])
    torch.cuda.synchronize()
    for key in ms:
        b_ms, b_by = bound(*costs[key], peak)
        print(f"  {tag} {key}: kernel {ms[key][0]:.3f} ms "
              f"({ms[key][0] / library[key]:.2f}x sdpa), plain "
              f"{ms[key][1]:.3f} ms, bound {b_ms:.3f} ms ({b_by}), sdpa "
              f"{library[key]:.3f} ms (forward + backward {sdpa[2]:.3f} ms)"
              + old.get(key, ""), flush=True)
    if all(length == n for length in lengths):
        # every key valid: SDPA needs no mask, and takes its fastest path
        bare = sdpa_ms(q, k, v, None, False, scale,
                       _heads_of(dattn.to(dt), 0))
        print(f"  {tag}: sdpa without a mask {bare[0]:.3f} ms forward, "
              f"{bare[1]:.3f} ms backward; kernel / sdpa "
              f"{ms['core_fwd'][0] / bare[0]:.2f}x forward, "
              f"{ms['core_bwd'][0] / bare[1]:.2f}x backward", flush=True)
    del qkv, dattn, want, q, k, v
    torch.cuda.empty_cache()
    return errs, ms, costs, library


# (key, record name, source, Pallas body replaced) of the memory-lean
# training kernels on the b = 2048 path (phase 11); K3's qkv mode is
# checked and timed in phase 9 but not on that path
LEAN_KERNELS = [
    ("kffs", "K-FF-s ff_block forward (stats)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:163"),
    ("ff_rc", "FF block recompute backward (K1 recompute / K4 fed bodies)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:456"),
    ("k3_fwd", "K3 attention_block forward (stats)",
     "xclip_tpu_torch/csrc/attention_megablock.cu",
     "xclip_tpu/kernels/attention_megablock.py:294"),
    ("k3_bwd", "K3 attention_block backward (recompute)",
     "xclip_tpu_torch/csrc/attention_megablock.cu",
     "xclip_tpu/kernels/attention_megablock.py:476"),
    ("k5_fwd", "K5 streaming_lse forward",
     "xclip_tpu_torch/csrc/fused_infonce.cu",
     "xclip_tpu/kernels/fused_infonce.py:66"),
    ("k5_bwd", "K5 streaming_lse backward (dx, dy)",
     "xclip_tpu_torch/csrc/fused_infonce.cu",
     "xclip_tpu/kernels/fused_infonce.py:121"),
]


# (key, record name, source, Pallas body replaced) of the rotary text
# tower's attention kernels, timed at the text tower's flagship shape
ATTN_KERNELS = [
    ("k6_fwd", "K6 attention_core forward",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_block.py:83"),
    ("k6_bwd", "K6 attention_core backward (dq, dk/dv)",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_block.py:117"),
    ("k7_fwd", "K7 flash_attention forward",
     "xclip_tpu_torch/csrc/flash_attention_sm90.cuh",
     "xclip_tpu/kernels/flash_attention.py:66"),
    ("k7_bwd", "K7 flash_attention backward (dq, dk/dv)",
     "xclip_tpu_torch/csrc/flash_attention_sm90.cuh",
     "xclip_tpu/kernels/flash_attention.py:134"),
]


def lean_kernels(gen, ffb, mega, lse5):
    """Phase 9: K-FF-s, the FF recompute backward, K3 and K5 at the
    flagship shapes, against their plain versions on the card."""
    phase(9, "lean-kernels", "kernel vs plain version on the card (bf16; "
          "K5 fp32)")
    dt = torch.bfloat16
    errs, ms, costs = {}, {}, {}
    for label, rows in (("text", 256 * 257), ("vision", 256 * 32)):
        args = ff_inputs(gen, rows, dt)
        tag = f"K-FF-s ({rows}, 512) -> 2x2048"
        got = ffb.ff_block_fwd_stats(*args)
        want = ffb.ff_block_fwd_stats_plain(*args)
        e_fwd = compare_all(tag, got, want, ("out", "stats"))
        stats = want[1]
        do = rand(gen, rows, 512, dtype=dt)
        del got, want
        e_bwd = compare_all(
            f"FF recompute backward ({rows}, 512)",
            ffb.ff_block_bwd_recompute(*args, do, stats),
            ffb.ff_block_bwd_recompute_plain(*args, do, stats),
            ("dx", "dg_pre", "dw_in", "dg_inner", "dw_out"))
        if label == "text":
            errs.update(kffs=e_fwd, ff_rc=e_bwd)
            ms["kffs"] = (cuda_ms(lambda: ffb.ff_block_fwd_stats(*args)),
                          cuda_ms(lambda: ffb.ff_block_fwd_stats_plain(
                              *args)))
            ms["ff_rc"] = (
                cuda_ms(lambda: ffb.ff_block_bwd_recompute(*args, do,
                                                           stats)),
                cuda_ms(lambda: ffb.ff_block_bwd_recompute_plain(*args, do,
                                                                 stats)))
            costs.update(kffs=ff_cost("fwd_stats", rows),
                         ff_rc=ff_cost("bwd_recompute", rows))
        del args, do, stats
        torch.cuda.empty_cache()
    for label, n in (("text", 257), ("vision", 32)):
        b = 256
        lengths = (torch.randint(1, n + 1, (b,), generator=gen,
                                 device="cuda").tolist()
                   if label == "text" else [n] * b)
        args = mega_inputs(gen, b, n, 512, 8, dt, lengths)
        static = (8, 64, 64 ** -0.5, False, label == "text")
        for keep in (False, True):
            mode = "qkv" if keep else "stats"
            tag = f"K3 {mode} ({b}, {n}, 512) 8x64"
            got = mega.attention_block_fwd_stats(*args, *static, keep)
            want = mega.attention_block_fwd_stats_plain(*args, *static, keep)
            names = ("out", "sm", "ln_stats", "qkv")[:3 + keep]
            e_fwd = compare_all(tag, got[:len(names)], want[:len(names)],
                                names)
            _, sm, ln_stats, qkv = want
            do = rand(gen, b, n, 512, dtype=dt)
            del got
            e_bwd = compare_all(
                f"{tag} backward",
                mega.attention_block_bwd_recompute(*args, do, sm, ln_stats,
                                                   *static, qkv=qkv),
                mega.attention_block_bwd_recompute_plain(
                    *args, do, sm, ln_stats, *static, qkv=qkv),
                ("dx", "dg_pre", "dw_qkv", "dw_out", "dg_out"))
            if label == "text":
                key = "k3q" if keep else "k3"
                errs.update({f"{key}_fwd": e_fwd, f"{key}_bwd": e_bwd})
                ms[f"{key}_fwd"] = (
                    cuda_ms(lambda: mega.attention_block_fwd_stats(
                        *args, *static, keep)),
                    cuda_ms(lambda: mega.attention_block_fwd_stats_plain(
                        *args, *static, keep)))
                ms[f"{key}_bwd"] = (
                    cuda_ms(lambda: mega.attention_block_bwd_recompute(
                        *args, do, sm, ln_stats, *static, qkv=qkv)),
                    cuda_ms(lambda: mega.attention_block_bwd_recompute_plain(
                        *args, do, sm, ln_stats, *static, qkv=qkv)))
                suffix = "_qkv" if keep else ""
                costs.update({f"{key}_fwd": mega_cost("fwd_stats" + suffix,
                                                      b, n, lengths),
                              f"{key}_bwd": mega_cost(
                                  "bwd_recompute" + suffix, b, n, lengths)})
            del want, sm, ln_stats, qkv, do
        del args
        torch.cuda.empty_cache()
    R, d = 2048, 512
    x = torch.nn.functional.normalize(rand(gen, R, d), dim=-1) * 14.0
    y = torch.nn.functional.normalize(rand(gen, R, d), dim=-1)
    lse = lse5.streaming_lse_fwd(x, y, 0, True)
    if not torch.equal(lse, lse5.streaming_lse_fwd(x, y, 0, True)):
        fail("K5 forward: two launches differ")
    print("  K5 (2048, 512) DCL forward: two launches bit for bit equal",
          flush=True)
    want = lse5.streaming_lse_fwd_plain(x, y, 0, True)
    # fp32 throughout: summation order only
    errs["k5_fwd"] = compare("K5 (2048, 512) DCL lse", lse, want, 1e-4)
    dlse = rand(gen, R)
    got = lse5.streaming_lse_bwd(x, y, want, dlse, 0, True)
    again = lse5.streaming_lse_bwd(x, y, want, dlse, 0, True)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        fail("K5 backward: two launches differ")
    print("  K5 (2048, 512) DCL backward: two launches bit for bit equal",
          flush=True)
    wgrad = lse5.streaming_lse_bwd_plain(x, y, want, dlse, 0, True)
    # fp32, summation order only: each gradient within 1e-5 of its own
    # largest magnitude, so a zero or scrambled gradient fails
    errs["k5_bwd"] = max(
        compare(f"K5 (2048, 512) DCL {name}", g, w,
                1e-5 * float(w.abs().max()))
        for name, g, w in zip(("dx", "dy"), got, wgrad))
    ms["k5_fwd"] = (cuda_ms(lambda: lse5.streaming_lse_fwd(x, y, 0, True)),
                    cuda_ms(lambda: lse5.streaming_lse_fwd_plain(x, y, 0,
                                                                 True)))
    ms["k5_bwd"] = (
        cuda_ms(lambda: lse5.streaming_lse_bwd(x, y, want, dlse, 0, True)),
        cuda_ms(lambda: lse5.streaming_lse_bwd_plain(x, y, want, dlse, 0,
                                                     True)))
    costs.update(k5_fwd=lse_cost("fwd", R, R, d), k5_bwd=lse_cost("bwd", R, R,
                                                                  d))
    torch.cuda.synchronize()
    for key in ms:
        b_ms, b_by = bound(*costs[key],
                           FP32_PEAK if key.startswith("k5") else BF16_PEAK)
        print(f"  {key}: kernel {ms[key][0]:.3f} ms, plain {ms[key][1]:.3f} "
              f"ms, bound {b_ms:.3f} ms ({b_by})", flush=True)
    del x, y, lse, want, dlse, got, again, wgrad
    torch.cuda.empty_cache()
    return errs, ms, costs


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def golden_outputs_err(CLIP, load_jax_params, numpy_params, golden=GOLDEN,
                       prefix=""):
    """The largest abs difference of the golden file's tiny CLIP's
    inference outputs on the card from the JAX package's."""
    g = np.load(golden)
    config = json.loads(str(g[f"{prefix}config"]))
    tiny = CLIP(**config, device="cuda")
    load_jax_params(tiny, numpy_params(config, int(g["seed"])))
    text = torch.from_numpy(g["text"]).cuda()
    images = torch.from_numpy(g["images"]).cuda().float()
    got = {"sims": tiny(text, images)}
    got["text_latents"], got["image_latents"] = tiny(text, images,
                                                     return_latents=True)
    et, ei = tiny(text, images, return_encodings=True)
    got["enc_text_head"], got["enc_image_head"] = et[:, :3], ei[:, :3]
    return max((v.float().cpu() - torch.from_numpy(g[f"{prefix}{k}"]))
               .abs().max().item() for k, v in got.items())


def train_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
                 make_train_step, number=7, prefix="", golden=GOLDEN):
    """Phase 7 (stored routes) or 10 (memory-lean routes, `prefix`
    "lean_"): one fp32 train step on the card against the JAX golden; with
    `number` None (phases 13 and 17) no phase line, the errors returned.
    The step runs under the environment the golden's was taken under
    (`<prefix>env`, if the file has one)."""
    from xclip_tpu_torch.convert import to_jax_tree
    g = np.load(golden)
    config = json.loads(str(g[f"{prefix}config"]))
    opt = json.loads(str(g["train_optimizer"]))
    env = (json.loads(str(g[f"{prefix}env"])) if f"{prefix}env" in g.files
           else {})
    tiny = CLIP(**config, device="cuda")
    load_jax_params(tiny, numpy_params(config, int(g["seed"])))
    step = make_train_step(tiny, default_optimizer(tiny.parameters(), **opt))
    with mock.patch.dict(os.environ, env):
        metrics = step(torch.from_numpy(g["train_text"]).cuda(),
                       torch.from_numpy(g["train_images"]).cuda().float(),
                       keep_idx=torch.from_numpy(g["train_keep_idx"]).cuda())
    loss_err = abs(metrics["loss"].item() - float(g[f"{prefix}train_loss"]))
    norm_err = abs(metrics["grad_norm"].item()
                   - float(g[f"{prefix}train_grad_norm"]))
    grad_worst = param_worst = 0.0
    for name, got in _flat(to_jax_tree(tiny, grads=True)):
        want = g[f"{prefix}grad/{name}"]
        err = float(np.abs(got - want).max())
        if not err <= 1e-3 * float(np.abs(want).max()) + 1e-5:
            fail(f"golden train step: gradient {name} differs by {err:.3e}")
        grad_worst = max(grad_worst, err)
    for name, got in _flat(to_jax_tree(tiny)):
        err = float(np.abs(got - g[f"{prefix}param1/{name}"]).max())
        if not err <= 1e-5:
            fail(f"golden train step: parameter {name} differs by {err:.3e}")
        param_worst = max(param_worst, err)
    if not (loss_err <= 1e-5 and norm_err <= 1e-4):
        fail(f"golden train step: loss err {loss_err:.3e}, grad norm err "
             f"{norm_err:.3e}")
    if number is None:
        return loss_err, norm_err, grad_worst, param_worst
    name = "lean-golden" if prefix else "train-golden"
    routes = "memory-lean" if prefix else "kernel"
    phase(number, name, f"tiny CLIP fp32 train step ({routes} routes) vs "
          f"JAX: loss err {loss_err:.3e} (tol 1e-5), grad_norm err "
          f"{norm_err:.3e} (tol 1e-4), max grad err {grad_worst:.3e} (tol "
          f"1e-3 of the leaf's magnitude + 1e-5), max param err after the "
          f"step {param_worst:.3e} (tol 1e-5)")


def device_events(prof):
    """The profiler's device activity (kernels, copies, sets), without the
    user-annotation ranges it mirrors on the device timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def idle_share(prof):
    """1 - (union of device-event intervals) / (first start to last end)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(prof))
    if not spans:
        fail("the profiler saw no device activity")
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return 1.0 - busy / window, busy / 1e3, window / 1e3


def top_kernels(prof, k=12):
    """(total device ms, [(ms, count, name)] of the k longest, or all with
    k None, longest first) over the profiler's device events, grouped by
    name."""
    by_name = {}
    for e in device_events(prof):
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + (e.time_range.end - e.time_range.start) / 1e3,
                           c + 1)
    rows = sorted(((t, c, name) for name, (t, c) in by_name.items()),
                  reverse=True)
    return sum(r[0] for r in rows), rows[:k]


def read_counts(counters):
    """{name: launches} of each counter in `counters`: a wrapper (its
    `.launches`), a row kernel's (kernel, mode) or the ordered sums' ("sum",
    regime, width) (their launches from every caller, counted in the
    library)."""
    from xclip_tpu_torch.kernels import rows as rk
    library = rk.kernel_launches()
    sums = rk.sum_launches()
    return {k: (sums.get(c[1:], 0) if c[0] == "sum" else library[c])
            if isinstance(c, tuple) else c.launches
            for k, c in counters.items()}


def zero_counts(counters):
    """Every counter in `counters` (as read_counts takes them) set to 0."""
    from xclip_tpu_torch.kernels import rows as rk
    rk.kernel_launches(reset=True)
    rk.sum_launches(reset=True)
    for c in counters.values():
        if not isinstance(c, tuple):
            c.launches = 0


def timed_steps(run, warm, timed, counters):
    """`warm` steps, then `timed` steps between CUDA events, every counter
    in `counters` set to 0 first: (ms per timed step, launch counts, peak
    memory in GiB, the losses on the CPU)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    losses = [run(i)["loss"] for i in range(warm)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [run(warm + i)["loss"] for i in range(timed)]
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / timed,
            read_counts(counters),
            torch.cuda.max_memory_allocated() / 2 ** 30,
            torch.stack(losses).float().cpu())


def check_losses(label, losses, b, tol=0.5):
    """Every loss finite, the first within `tol` of ln b (the loss of
    untrained latents)."""
    if not torch.isfinite(losses).all():
        fail(f"{label}: a loss is not finite: {losses.tolist()}")
    if not abs(losses[0].item() - math.log(b)) <= tol:
        fail(f"{label}: first loss {losses[0].item():.4f} is not within "
             f"{tol} of ln {b} = {math.log(b):.4f}")


def train_flagship(card, CLIP, default_optimizer, make_train_step, ffb, mega,
                   row_counters):
    """Phase 8: the flagship train step on the kernel and plain routes."""
    b, warm, timed = 256, 2, 5
    gen = torch.Generator(device="cuda").manual_seed(8)
    text, images = texts(gen, b), rand(gen, b, 3, 256, 256,
                                       dtype=torch.bfloat16)
    kernel = CLIP(**FLAGSHIP, **KERNEL_ROUTES, param_dtype=torch.bfloat16,
                  compute_dtype="bfloat16", device="cuda", seed=0)
    init = {k: v.clone() for k, v in kernel.state_dict().items()}
    counters = {"k1_fwd": ffb.ff_block_fwd_stored, "k1_p1": ffb.ff_block_bwd_p1,
                "k1_p2": ffb.ff_block_bwd_p2,
                "k2_fwd": mega.attention_block_fwd_stored,
                "k2_bwd": mega.attention_block_bwd,
                "rows_ln_geglu": row_counters["rows_ln_geglu"],
                "rows_ln_ln": row_counters["rows_ln_ln"],
                "rows_ln_fwd_in_copy": row_counters["rows_ln_fwd_in_copy"]}
    results = {}
    for route, routes in (("kernel", KERNEL_ROUTES), ("plain", PLAIN_ROUTES)):
        model = kernel if route == "kernel" else CLIP(
            **FLAGSHIP, **routes, param_dtype=torch.bfloat16,
            compute_dtype="bfloat16", device="cuda")
        model.load_state_dict(init)
        step = make_train_step(model, default_optimizer(model.parameters(),
                                                        learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=torch.Generator(
                device="cuda").manual_seed(100 + i))

        step_ms, counts, peak, losses = timed_steps(
            run, warm, timed, counters if route == "kernel" else {})
        (idle, busy_ms, window_ms), (total, rows) = profile_step(
            run, warm + timed)
        check_losses(f"{route} routes", losses, b)
        results[route] = (step_ms, peak, idle, busy_ms, window_ms, losses)
        print(f"  {route} routes: {b * 1e3 / step_ms:.1f} pairs/s "
              f"({step_ms:.2f} ms per step), peak memory {peak:.2f} GiB, "
              f"idle share {idle:.4f} over one step (device busy "
              f"{busy_ms:.2f} of {window_ms:.2f} ms), losses "
              + " ".join(f"{v:.4f}" for v in losses.tolist()), flush=True)
        for t, count, key in rows[:12]:
            print(f"    {t:8.3f} ms {100 * t / total:5.1f} % x{count:<4d} "
                  f"{key[:90]}", flush=True)
        if route == "kernel":
            per_step = {k: v / (warm + timed) for k, v in counts.items()}
            # K1's pass 1: a GEGLU-mode and a plain LayerNorm-backward
            # launch; K2's backward two plain ones; K1's forward one
            # in_copy LayerNorm forward (its inner LayerNorm)
            want = {"k1_fwd": 12, "k1_p1": 12, "k1_p2": 12, "k2_fwd": 6,
                    "k2_bwd": 6, "rows_ln_geglu": 12, "rows_ln_ln": 24,
                    "rows_ln_fwd_in_copy": 12}
            if per_step != want:
                fail(f"training launches per step {per_step}, expected "
                     f"{want}")
            launches = counts
        del model, step
        torch.cuda.empty_cache()
    k, p = results["kernel"], results["plain"]
    phase(8, "train", f"{card}: flagship train step b={b} bf16: kernel "
          f"routes {b * 1e3 / k[0]:.1f} pairs/s ({k[0]:.2f} ms, peak "
          f"{k[1]:.2f} GiB, idle {k[2]:.4f}), plain routes "
          f"{b * 1e3 / p[0]:.1f} pairs/s ({p[0]:.2f} ms, peak {p[1]:.2f} "
          f"GiB, idle {p[2]:.4f}); launches per step K1 fwd/p1/p2 12, "
          f"K2 fwd/bwd 6, LN-backward rows 12 GEGLU mode + 24")
    return launches, k


# kernels phase 11 lists by instance from its profile, whatever their rank
PROFILED = ("ln_fwd_rows_kernel", "lse_merge_kernel", "k5_gemm_kernel",
            "k5_sum_kernel", "k6_fwd", "k6_bwd", "reduce_parts")


def profile_step(run, i):
    """The idle share and top kernels of one step, profiled after one more
    that only warms the profiler up."""
    for j in range(2):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(i + j)
            torch.cuda.synchronize()
    return idle_share(prof), top_kernels(prof, k=None)


def lean_train(card, CLIP, default_optimizer, make_train_step, counters,
               stored, products_per_step, rows_per_step):
    """Phase 11: the flagship train step on the memory-lean routes, at
    b = 256 (phase 8's weights and inputs; `stored` its kernel-route
    result) and at b = 2048, where the bf16 product kernel's launches by
    instance (counted in the library) must be `products_per_step` a step;
    the row kernels' launches (in `counters`) `rows_per_step(b)` a step.
    Returns the b = 2048 run's launch counts, product launches and (ms
    per step, peak GiB)."""
    from xclip_tpu_torch.kernels import matmul
    # the core: K3's forward and its backward's recompute, K3's backward
    base = {"k3_fwd": 12, "k3_bwd": 12, "kffs": 12, "ff_rc": 12,
            "k5_fwd": 2, "k5_bwd": 2, "core_fwd": 24, "core_bwd": 12}
    results = {}
    for b, warm, timed, seed in ((256, 2, 5, 8), (2048, 2, 3, 11)):
        want = {**base, **rows_per_step(b)}
        gen = torch.Generator(device="cuda").manual_seed(seed)
        text, images = texts(gen, b), rand(gen, b, 3, 256, 256,
                                           dtype=torch.bfloat16)
        model = CLIP(**FLAGSHIP, **LEAN_ROUTES, param_dtype=torch.bfloat16,
                     compute_dtype="bfloat16", device="cuda", seed=0)
        step = make_train_step(model, default_optimizer(model.parameters(),
                                                        learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=torch.Generator(
                device="cuda").manual_seed(100 + i))

        matmul.kernel_launches(reset=True)
        step_ms, counts, peak, losses = timed_steps(run, warm, timed,
                                                    counters)
        products = matmul.kernel_launches()
        check_losses(f"lean routes b={b}", losses, b)
        per_step = {k: v / (warm + timed) for k, v in counts.items()}
        if per_step != want:
            fail(f"lean routes b={b}: launches per step {per_step}, "
                 f"expected {want}")
        line = (f"  lean routes b={b}: {b * 1e3 / step_ms:.1f} pairs/s "
                f"({step_ms:.2f} ms per step), peak memory {peak:.2f} GiB, "
                f"losses " + " ".join(f"{v:.4f}" for v in losses.tolist()))
        if b == 256:
            # the same weights, inputs and patch draws as phase 8: the same
            # function through other kernels, rounded at other places in bf16
            diff = abs(losses[0].item() - stored[5][0].item())
            if not diff <= 0.05:
                fail(f"lean vs stored routes, first loss differs by "
                     f"{diff:.4f} > 0.05")
            line += (f"; stored routes (phase 8) "
                     f"{b * 1e3 / stored[0]:.1f} pairs/s, peak "
                     f"{stored[1]:.2f} GiB, first loss differs by {diff:.4f}"
                     f" (tol 0.05)")
            if not peak < stored[1]:
                fail(f"lean peak {peak:.2f} GiB is not below the stored "
                     f"routes' {stored[1]:.2f} GiB")
        print(line, flush=True)
        if b == 2048:
            want_mm = {k: v * (warm + timed)
                       for k, v in products_per_step.items()}
            if products != want_mm:
                fail(f"lean routes b={b}: product kernel launches "
                     f"{products}, expected {want_mm}")
            print(f"  b={b} bf16 product kernel launches per step "
                  f"{sum(products_per_step.values())}: "
                  + ", ".join(f"{k[0]} ta={int(k[1])} tb={int(k[2])} {v}"
                              for k, v in products_per_step.items()),
                  flush=True)
            (idle, busy_ms, window_ms), (total, rows) = profile_step(
                run, warm + timed)
            print(f"  b={b} idle share {idle:.4f} over one step (device busy "
                  f"{busy_ms:.2f} of {window_ms:.2f} ms)", flush=True)
            for t, count, key in rows[:12]:
                print(f"    {t:8.3f} ms {100 * t / total:5.1f} % x{count:<4d} "
                      f"{key[:90]}", flush=True)
            print(f"  b={b} LayerNorm forward rows, K5, the attention "
                  "core and the ordered sums by instance:", flush=True)
            for t, count, key in rows:
                if any(k in key for k in PROFILED):
                    print(f"    {t:8.3f} ms {100 * t / total:5.1f} % "
                          f"x{count:<4d} {key[:120]}", flush=True)
            print(f"  b={b} ordered sums per step by (regime, width), "
                  f"named by call site: " + ", ".join(
                      f"{k} {SUM_SITES[k][1]} {SUM_SITES[k][2]} "
                      f"{per_step[k]:g}" for k in SUM_SITES)
                  + f"; {sum(per_step[k] for k in SUM_SITES):g} in all",
                  flush=True)
            results[b] = (step_ms, peak, idle, counts, products)
        else:
            results[b] = (step_ms, peak)
        del model, step, text, images
        torch.cuda.empty_cache()
    s256, s2048 = results[256], results[2048]
    phase(11, "lean-train", f"{card}: flagship memory-lean train step bf16: "
          f"b=256 {256e3 / s256[0]:.1f} pairs/s (peak {s256[1]:.2f} GiB; "
          f"stored routes {256e3 / stored[0]:.1f} pairs/s, peak "
          f"{stored[1]:.2f} GiB); b=2048 {2048e3 / s2048[0]:.1f} pairs/s "
          f"({s2048[0]:.1f} ms per step, peak {s2048[1]:.2f} GiB, idle "
          f"{s2048[2]:.4f}); launches per step K3 fwd/bwd 12, K-FF-s 12, FF "
          f"recompute backward 12, K5 fwd/bwd 2, megablock core fwd/bwd 24"
          f"/12, bf16 product kernel {sum(products_per_step.values())}, "
          f"GEGLU-backward rows {rows_per_step(2048)['rows_geglu_recompute']}"
          f", LN-backward rows {rows_per_step(2048)['rows_ln_ln']}, ordered "
          f"sums {sum(rows_per_step(2048)[k] for k in SUM_SITES)}")
    return s2048[3], s2048[4], s2048[:2]


def rotary_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
                  make_train_step, counters):
    """Phase 13: the rotary causal-EOS tiny CLIP on the K6 and K7 routes
    against the JAX golden, fp32: outputs and one train step, each route
    through its kernels. Returns the kernels' launches (fp32) by key."""
    lines, launches = [], {}
    for route, prefix, keys in (("K6", "fused_", ("k6_fwd", "k6_bwd")),
                                ("K7", "flash_", ("k7_fwd", "k7_bwd"))):
        before = {k: counters[k].launches for k in keys}
        worst = golden_outputs_err(CLIP, load_jax_params, numpy_params,
                                   GOLDEN_ROTARY, prefix)
        if not worst <= 1e-4:
            fail(f"rotary {route} route vs JAX golden: max_abs_err "
                 f"{worst:.3e} > 1e-4")
        loss_err, norm_err, grad_worst, param_worst = train_golden(
            CLIP, load_jax_params, numpy_params, default_optimizer,
            make_train_step, None, prefix, GOLDEN_ROTARY)
        launches.update({k: counters[k].launches - before[k] for k in keys})
        missed = [k for k in keys if launches[k] == 0]
        if missed:
            fail(f"the rotary golden model did not run through {missed}")
        lines.append(f"{route} route outputs max_abs_err {worst:.3e} (tol "
                     f"1e-4), train step loss err {loss_err:.3e} (tol 1e-5),"
                     f" grad_norm err {norm_err:.3e} (tol 1e-4), max grad err"
                     f" {grad_worst:.3e}, max param err {param_worst:.3e} "
                     f"(tol 1e-5)")
    phase(13, "rotary-golden", "rotary causal-EOS tiny CLIP fp32 vs JAX: "
          + "; ".join(lines))
    return launches


def rotary_models(CLIP, routes_by_name, dtype=torch.bfloat16):
    """The flagship rotary causal-EOS CLIP on each named route, all with
    the first one's weights."""
    models = {}
    for name, routes in routes_by_name.items():
        models[name] = CLIP(**FLAGSHIP, **ROTARY, **routes, param_dtype=dtype,
                            compute_dtype="bfloat16", device="cuda", seed=0)
        models[name].load_state_dict(next(iter(models.values())).state_dict())
    return models


def rotary_serve(card, CLIP, counters):
    """Phase 14: the flagship rotary causal-EOS CLIP serves b = 256 on the
    K6, K7 and plain routes."""
    b = 256
    gen = torch.Generator(device="cuda").manual_seed(14)
    text, images = eos_texts(gen, b), rand(gen, b, 3, 256, 256)
    models = rotary_models(CLIP, {**ROTARY_ROUTES, "plain": PLAIN_ROUTES})
    want = {"K6": {"k6_fwd": 6, "k6_bwd": 0, "k7_fwd": 0, "k7_bwd": 0,
                   "kff": 12},
            "K7": {"k6_fwd": 0, "k6_bwd": 0, "k7_fwd": 12, "k7_bwd": 0,
                   "kff": 12}}
    plain = models["plain"](text, images, return_latents=True)
    agree = []
    for route in ROTARY_ROUTES:
        zero_counts(counters)
        latents = models[route](text, images, return_latents=True)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        if counts != want[route]:
            fail(f"rotary {route} route: launches {counts}, expected "
                 f"{want[route]}")
        worst = max((a - p).abs().max().item()
                    for a, p in zip(latents, plain))
        if not (worst <= LATENT_TOL[torch.bfloat16]
                and all(torch.isfinite(t).all() for t in latents)):
            fail(f"rotary {route} route: latents differ from the plain "
                 f"route's by {worst:.3e} > {LATENT_TOL[torch.bfloat16]}")
        agree.append(f"{route} latents vs plain {worst:.3e} (tol "
                     f"{LATENT_TOL[torch.bfloat16]:.0e}), launches "
                     f"{counts}")
    ms = {}
    for route in ("plain", "K6", "K7", "K7_2", "K6_2", "plain_2"):
        model = models[route.split("_")[0]]
        ms[route] = cuda_ms(lambda: model(text, images), reps=3, iters=2)
    best = {r: min(ms[r], ms[f"{r}_2"]) for r in ("plain", "K6", "K7")}
    phase(14, "rotary-serve", f"{card}: rotary causal-EOS flagship inference"
          f" b={b} bf16: " + ", ".join(
              f"{r} route {b / best[r] * 1e3:.1f} pairs/s ({ms[r]:.2f}, "
              f"{ms[r + '_2']:.2f} ms)" for r in ("K6", "K7", "plain"))
          + "; " + "; ".join(agree))
    del models, plain
    torch.cuda.empty_cache()


def rotary_train(card, CLIP, default_optimizer, make_train_step, counters):
    """Phase 15: the flagship rotary causal-EOS train step on the K6 and K7
    routes, b = 256, from the same weights and inputs."""
    b, warm, timed = 256, 2, 5
    gen = torch.Generator(device="cuda").manual_seed(15)
    text, images = eos_texts(gen, b), rand(gen, b, 3, 256, 256,
                                           dtype=torch.bfloat16)
    models = rotary_models(CLIP, ROTARY_ROUTES)
    # K1's pass 1: a GEGLU-mode and a plain LayerNorm-backward launch
    k1_rows = {"rows_ln_geglu": 12, "rows_ln_ln": 12}
    want = {"K6": {"k6_fwd": 6, "k6_bwd": 6, "k7_fwd": 0, "k7_bwd": 0,
                   "k1_fwd": 12, "k1_p1": 12, "k1_p2": 12, **k1_rows},
            "K7": {"k6_fwd": 0, "k6_bwd": 0, "k7_fwd": 12, "k7_bwd": 12,
                   "k1_fwd": 12, "k1_p1": 12, "k1_p2": 12, **k1_rows}}
    results, launches = {}, {}
    for route, model in models.items():
        step = make_train_step(model, default_optimizer(model.parameters(),
                                                        learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=torch.Generator(
                device="cuda").manual_seed(100 + i))

        step_ms, counts, peak, losses = timed_steps(run, warm, timed,
                                                    counters)
        per_step = {k: v / (warm + timed) for k, v in counts.items()}
        if per_step != want[route]:
            fail(f"rotary {route} route: training launches per step "
                 f"{per_step}, expected {want[route]}")
        (idle, busy_ms, window_ms), (total, rows) = profile_step(
            run, warm + timed)
        check_losses(f"rotary {route} route", losses, b)
        print(f"  {route} route: {b * 1e3 / step_ms:.1f} pairs/s "
              f"({step_ms:.2f} ms per step), peak memory {peak:.2f} GiB, "
              f"idle share {idle:.4f} over one step (device busy "
              f"{busy_ms:.2f} of {window_ms:.2f} ms), launches per step "
              f"{per_step}, losses "
              + " ".join(f"{v:.4f}" for v in losses.tolist()), flush=True)
        for t, count, key in rows[:12]:
            print(f"    {t:8.3f} ms {100 * t / total:5.1f} % x{count:<4d} "
                  f"{key[:90]}", flush=True)
        results[route] = (step_ms, peak, idle, losses)
        launches.update({k: v for k, v in counts.items() if want[route][k]
                         and k.startswith(route.lower())})
        del step
        torch.cuda.empty_cache()
    diff = abs(results["K6"][3][0].item() - results["K7"][3][0].item())
    if not diff <= 0.05:
        fail(f"rotary K6 vs K7 routes: first losses differ by {diff:.4f} > "
             f"0.05")
    phase(15, "rotary-train", f"{card}: rotary causal-EOS flagship train "
          f"step b={b} bf16: " + ", ".join(
              f"{r} route {b * 1e3 / v[0]:.1f} pairs/s ({v[0]:.2f} ms, peak "
              f"{v[1]:.2f} GiB, idle {v[2]:.4f})" for r, v in results.items())
          + f"; first losses differ by {diff:.4f} (tol 0.05); launches per "
          f"step K6 fwd/bwd 6, K7 fwd/bwd 12, K1 fwd/p1/p2 12, LN-backward "
          f"rows 12 GEGLU mode + 12")
    del models
    torch.cuda.empty_cache()
    return launches


# (key, record name, source, Pallas body replaced) of the last two kernel
# families: K8 on the 'fused' FF route, K1-h on the stored-h route (its
# pass 2 is K1's kernel, on the operands K1-h's pass 1 hands it)
FF_KERNELS = [
    ("k8_fwd", "K8 geglu_layernorm forward",
     "xclip_tpu_torch/csrc/fused_ff.cu", "xclip_tpu/kernels/fused_ff.py:68"),
    ("k8_bwd", "K8 geglu_layernorm backward (dh, dg)",
     "xclip_tpu_torch/csrc/fused_ff.cu", "xclip_tpu/kernels/fused_ff.py:114"),
    ("k1h_fwd", "K1-h ff_block forward (stored h)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:251"),
    ("k1h_p1", "K1-h ff_block backward pass 1 (dx)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:540"),
    ("k1h_p2", "K1-h ff_block backward pass 2 (dW)",
     "xclip_tpu_torch/csrc/fused_ff_block.cu",
     "xclip_tpu/kernels/fused_ff_block.py:779"),
]


def ff_kernels(gen, ffb, k8):
    """Phase 16: K8 and K1-h against their plain versions on the card at
    the flagship's text and vision rows, fp32 and bf16; times (bf16, text
    rows) and bounds."""
    phase(16, "ff-kernels", "K8 and K1-h vs plain version on the card")
    errs, ms = {}, {}
    text_rows = 256 * 257
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for rows in (text_rows, 256 * 32):
            h = rand(gen, rows, 2 * 2048, dtype=dtype)
            g = 1 + rand(gen, 2048, scale=0.1, dtype=dtype)
            do = rand(gen, rows, 2048, dtype=dtype)
            label = f"K8 {tag} ({rows}, 2x2048)"
            e8f = compare_all(label, (k8.geglu_layernorm_fwd(h, g),),
                             (k8.geglu_layernorm_plain(h, g),), ("out",),
                             dtype)
            e8b = compare_all(label, k8.geglu_layernorm_bwd(h, g, do),
                             k8.geglu_layernorm_bwd_plain(h, g, do),
                             ("dh", "dg"), dtype)
            args = ff_inputs(gen, rows, dtype)
            label = f"K1-h {tag} ({rows}, 512) -> 2x2048"
            out, stored = ffb.ff_block_fwd_stored_h(*args)
            want_out, want_stored = ffb.ff_block_fwd_stored_h_plain(*args)
            ehf = compare_all(label, (out, *stored), (want_out, *want_stored),
                             ("out", "h", "stats"), dtype)
            del out, stored, want_out
            dout = rand(gen, rows, 512, dtype=dtype)
            p1 = ffb.ff_block_bwd_p1_stored_h(*args, dout, want_stored)
            want_p1 = ffb.ff_block_bwd_p1_stored_h_plain(*args, dout,
                                                         want_stored)
            eh1 = compare_all(label, (*p1[:4], *p1[4]),
                             (*want_p1[:4], *want_p1[4]),
                             ("dx", "dprod", "dg_pre", "dg_inner", "xn",
                              "dh2", "y2"), dtype)
            ops = want_p1[4]
            del p1, want_p1
            eh2 = compare_all(label, ffb.ff_block_bwd_p2(*ops, dout),
                             ffb.ff_block_bwd_p2_plain(*ops, dout),
                             ("dw_in", "dw_out"), dtype)
            if dtype == torch.bfloat16 and rows == text_rows:
                errs.update(k8_fwd=e8f, k8_bwd=e8b, k1h_fwd=ehf, k1h_p1=eh1,
                            k1h_p2=eh2)
                ms["k8_fwd"] = (
                    cuda_ms(lambda: k8.geglu_layernorm_fwd(h, g)),
                    cuda_ms(lambda: k8.geglu_layernorm_plain(h, g)))
                ms["k8_bwd"] = (
                    cuda_ms(lambda: k8.geglu_layernorm_bwd(h, g, do)),
                    cuda_ms(lambda: k8.geglu_layernorm_bwd_plain(h, g, do)))
                ms["k1h_fwd"] = (
                    cuda_ms(lambda: ffb.ff_block_fwd_stored_h(*args)),
                    cuda_ms(lambda: ffb.ff_block_fwd_stored_h_plain(*args)))
                ms["k1h_p1"] = (
                    cuda_ms(lambda: ffb.ff_block_bwd_p1_stored_h(
                        *args, dout, want_stored)),
                    cuda_ms(lambda: ffb.ff_block_bwd_p1_stored_h_plain(
                        *args, dout, want_stored)))
                ms["k1h_p2"] = (
                    cuda_ms(lambda: ffb.ff_block_bwd_p2(*ops, dout)),
                    cuda_ms(lambda: ffb.ff_block_bwd_p2_plain(*ops, dout)))
            del h, g, do, args, dout, want_stored, ops
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    costs = {"k8_fwd": geglu_ln_cost("fwd", text_rows),
             "k8_bwd": geglu_ln_cost("bwd", text_rows),
             "k1h_fwd": ff_cost("fwd_stored_h", text_rows),
             "k1h_p1": ff_cost("p1_h", text_rows),
             "k1h_p2": ff_cost("p2", text_rows)}
    peaks = {k: FP32_PEAK if k.startswith("k8") else BF16_PEAK
             for k in costs}
    for key, name, _, _ in FF_KERNELS:
        b_ms, b_by = bound(*costs[key], peaks[key])
        print(f"  {name} bf16 ({text_rows} rows): kernel {ms[key][0]:.3f} "
              f"ms, plain {ms[key][1]:.3f} ms, bound {b_ms:.3f} ms ({b_by})",
              flush=True)
    return errs, ms, costs, peaks


def ff_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
              make_train_step, counters):
    """Phase 17: the tiny CLIP of the FF golden on the card, fp32: the K8
    route's outputs and train step, and the stored-h train step (the file
    names the environment it runs under); K8 and K1-h must run."""
    before = read_counts(counters)
    worst = golden_outputs_err(CLIP, load_jax_params, numpy_params,
                               GOLDEN_FF, "fused_")
    if not worst <= 1e-4:
        fail(f"K8 route vs JAX golden: max_abs_err {worst:.3e} > 1e-4")
    lines = [f"K8 route outputs max_abs_err {worst:.3e} (tol 1e-4)"]
    for route, prefix in (("K8", "fused_"), ("stored-h", "stored_h_")):
        loss_err, norm_err, grad_worst, param_worst = train_golden(
            CLIP, load_jax_params, numpy_params, default_optimizer,
            make_train_step, None, prefix, GOLDEN_FF)
        lines.append(f"{route} train step loss err {loss_err:.3e} (tol "
                     f"1e-5), grad_norm err {norm_err:.3e} (tol 1e-4), max "
                     f"grad err {grad_worst:.3e}, max param err "
                     f"{param_worst:.3e} (tol 1e-5)")
    after = read_counts(counters)
    missed = [k for k in counters if after[k] == before[k]]
    if missed:
        fail(f"the FF golden model did not run through {missed}")
    if os.environ.get("XCLIP_FF_STORE") is not None:
        fail("XCLIP_FF_STORE is still set after the stored-h golden step")
    phase(17, "ff-golden", "tiny CLIP fp32 vs JAX: " + "; ".join(lines))


def ff_routes(card, CLIP, default_optimizer, make_train_step, counters,
              stored):
    """Phase 18: the flagship on the K8 route (serving and training) and
    on the stored-h route (training), b = 256, bf16, from phase 8's
    weights and inputs (`stored`: phase 8's kernel-route result)."""
    b, warm, timed = 256, 2, 5
    gen = torch.Generator(device="cuda").manual_seed(8)
    text, images = texts(gen, b), rand(gen, b, 3, 256, 256,
                                       dtype=torch.bfloat16)
    kernel = CLIP(**FLAGSHIP, **KERNEL_ROUTES, param_dtype=torch.bfloat16,
                  compute_dtype="bfloat16", device="cuda", seed=0)
    init = {k: v.clone() for k, v in kernel.state_dict().items()}
    k8_model = CLIP(**FLAGSHIP, **K8_ROUTES, param_dtype=torch.bfloat16,
                    compute_dtype="bfloat16", device="cuda")
    k8_model.load_state_dict(init)

    # serving: the K8 route beside the kernel routes, one forward counted
    zero_counts(counters)
    latents = k8_model(text, images, return_latents=True)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    want = {k: 0 for k in counters}
    want.update(k8_fwd=12, mega=6, rows_ln_fwd_geglu=12)
    if counts != want:
        fail(f"K8 route serving: launches {counts}, expected {want}")
    worst = max((a - p).abs().max().item() for a, p in zip(
        latents, kernel(text, images, return_latents=True)))
    if not (worst <= LATENT_TOL[torch.bfloat16]
            and all(torch.isfinite(t).all() for t in latents)):
        fail(f"K8 route latents differ from the kernel routes' by "
             f"{worst:.3e} > {LATENT_TOL[torch.bfloat16]}")
    ms = {}
    for route in ("kernel", "K8", "K8_2", "kernel_2"):
        model = k8_model if route.startswith("K8") else kernel
        ms[route] = cuda_ms(lambda: model(text, images), reps=3, iters=2)
    serve = {r: min(ms[r], ms[f"{r}_2"]) for r in ("kernel", "K8")}
    print(f"  serving b={b}: K8 route {b / serve['K8'] * 1e3:.1f} pairs/s "
          f"({ms['K8']:.2f}, {ms['K8_2']:.2f} ms), kernel routes "
          f"{b / serve['kernel'] * 1e3:.1f} pairs/s ({ms['kernel']:.2f}, "
          f"{ms['kernel_2']:.2f} ms); latents vs kernel routes {worst:.3e} "
          f"(tol {LATENT_TOL[torch.bfloat16]:.0e}), launches {counts}",
          flush=True)
    del kernel, latents
    torch.cuda.empty_cache()

    # training: K8 route, then phase 8's routes with XCLIP_FF_STORE=h
    # the row kernels: K8's backward its K8 mode, K1-h's pass 1 the
    # stored-h mode and a LayerNorm backward, K2's backward two of those
    want = {"K8": dict(k8_fwd=12, k8_bwd=12, k2_fwd=6, k2_bwd=6,
                       rows_geglu_k8=12, rows_ln_ln=12,
                       rows_ln_fwd_geglu=12),
            "stored-h": dict(k1h_fwd=12, k1h_p1=12, k1h_p2=12, k2_fwd=6,
                             k2_bwd=6, rows_geglu_stored_h=12,
                             rows_ln_ln=24)}
    results, launches = {}, {}
    for route, env in (("K8", {}), ("stored-h", STORED_H)):
        model = k8_model if route == "K8" else CLIP(
            **FLAGSHIP, **KERNEL_ROUTES, param_dtype=torch.bfloat16,
            compute_dtype="bfloat16", device="cuda")
        model.load_state_dict(init)
        step = make_train_step(model, default_optimizer(model.parameters(),
                                                        learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=torch.Generator(
                device="cuda").manual_seed(100 + i))

        with mock.patch.dict(os.environ, env):
            step_ms, counts, peak, losses = timed_steps(run, warm, timed,
                                                        counters)
            (idle, busy_ms, window_ms), (total, rows) = profile_step(
                run, warm + timed)
        per_step = {k: v / (warm + timed) for k, v in counts.items() if v}
        if per_step != want[route]:
            fail(f"{route} route: training launches per step {per_step}, "
                 f"expected {want[route]}")
        check_losses(f"{route} route", losses, b, tol=0.1)
        # the same weights, inputs and patch draws as phase 8
        diff = abs(losses[0].item() - stored[5][0].item())
        if not diff <= 0.05:
            fail(f"{route} vs stored routes: first loss differs by "
                 f"{diff:.4f} > 0.05")
        print(f"  {route} route: {b * 1e3 / step_ms:.1f} pairs/s "
              f"({step_ms:.2f} ms per step), peak memory {peak:.2f} GiB, "
              f"idle share {idle:.4f} over one step (device busy "
              f"{busy_ms:.2f} of {window_ms:.2f} ms), launches per step "
              f"{per_step}, first loss vs phase 8 {diff:.4f} (tol 0.05), "
              f"losses " + " ".join(f"{v:.4f}" for v in losses.tolist()),
              flush=True)
        for t, count, key in rows[:12]:
            print(f"    {t:8.3f} ms {100 * t / total:5.1f} % x{count:<4d} "
                  f"{key[:90]}", flush=True)
        results[route] = (step_ms, peak, idle)
        launches.update({k: counts[k] for k in want[route] if k.startswith(
            ("k8", "rows_geglu_k8", "rows_ln_fwd_geglu") if route == "K8"
            else ("k1h", "rows_geglu_stored_h"))})
        del model, step
        torch.cuda.empty_cache()
    if os.environ.get("XCLIP_FF_STORE") is not None:
        fail("XCLIP_FF_STORE is still set after the stored-h route")
    phase(18, "ff-routes", f"{card}: flagship b={b} bf16: K8 route serving "
          f"{b / serve['K8'] * 1e3:.1f} pairs/s (kernel routes "
          f"{b / serve['kernel'] * 1e3:.1f}); training " + ", ".join(
              f"{r} route {b * 1e3 / v[0]:.1f} pairs/s ({v[0]:.2f} ms, peak "
              f"{v[1]:.2f} GiB, idle {v[2]:.4f})" for r, v in results.items())
          + f"; stored routes (phase 8) {b * 1e3 / stored[0]:.1f} pairs/s, "
          f"peak {stored[1]:.2f} GiB; launches per step K8 fwd/bwd 12, K1-h "
          f"fwd/p1/p2 12, K2 fwd/bwd 6, GEGLU-backward rows 12 (K8 or "
          f"stored-h mode), LN-backward rows 12 / 24")
    return launches


# The bf16 product kernel's classes on the b = 2048 step (phase 19): (key,
# class, epilogues, ta, tb, [(call, call site, m, n, k)], Pallas body
# replaced), "R" the rows of a call; the call sites' row chunks are those of
# the step's text tower. The first call of a class is its record's.
PRODUCT_CLASSES = [
    ("mm_wgrad", "weight gradients A^T.B, split-k", ("store_f32",), True,
     False, [("FF dW_in", "ff_bwd", 512, 4096, "R"),
             ("FF dW_out", "ff_bwd", 2048, 512, "R"),
             ("attn dW_out", "mega_bwd", 512, 512, "R"),
             ("dW_qkv", "mega_bwd", 512, 1536, "R")],
     "xclip_tpu/kernels/fused_ff_block.py:697"),
    ("mm_abt", "A.B^T to fp32", ("store_f32",), False, True,
     [("FF dxn", "ff_bwd", "R", 512, 4096), ("dy", "ff_bwd", "R", 2048, 512),
      ("dattn", "mega_bwd", "R", 512, 512),
      ("attn dxn", "mega_bwd", "R", 512, 1536)],
     "xclip_tpu/kernels/fused_ff_block.py:411"),
    ("mm_ab32", "A.B to fp32", ("store_f32",), False, False,
     [("h", "ff_bwd", "R", 4096, 512), ("proj", "mega_bwd", "R", 512, 512)],
     "xclip_tpu/kernels/fused_ff_block.py:387"),
    ("mm_geglu", "GEGLU forward", ("geglu", "geglu_triple", "geglu_h"),
     False, False, [("xn.W_in", "ff_fwd", "R", 2048, 512)],
     "xclip_tpu/kernels/fused_ff_block.py:150"),
    ("mm_qkv", "qkv", ("store",), False, False,
     [("xn.W_qkv", "mega_fwd", "R", 1536, 512)],
     "xclip_tpu/kernels/attention_megablock.py:120"),
    ("mm_resid", "FF out + residual", ("residual",), False, False,
     [("y.W_out + x", "ff_fwd", "R", 512, 2048)],
     "xclip_tpu/kernels/fused_ff_block.py:158"),
]
# phase 19's fp32 rows: one SSL pass of phase 23 (256 images of 32 kept
# patches and CLS in fp32 views) and the flagship text tower's 256 x 257
F32_ROWS = (256 * 33, 256 * 257)


def product_operands(gen, cls, rows, call=0, epilogue=None,
                     dt=torch.bfloat16):
    """Operands in `dt` of call `call` of class `cls` (a PRODUCT_CLASSES
    entry) at `rows` rows, unit-scale A and B scaled by k^-1/2, and how to
    run it: a dict for run_mm."""
    from xclip_tpu_torch.kernels import matmul
    key, _, epilogues, ta, tb, calls, _ = cls
    name, _, m, n, k = calls[call]
    m, n, k = (rows if v == "R" else v for v in (m, n, k))
    epi = epilogue or epilogues[0]
    width = 2 * n if epi.startswith("geglu") else n
    a = rand(gen, *((k, m) if ta else (m, k)), dtype=dt)
    b = rand(gen, *((width, k) if tb else (k, width)), scale=k ** -0.5,
             dtype=dt)
    names = {"geglu_triple": ("prod", "gelu_b", "agdb"),
             "geglu_h": ("prod", "h")}.get(epi, ("out",))
    return {"tag": f"{epi} ta={int(ta)} tb={int(tb)} {name} ({m} x {n} x "
                   f"{k})", "a": a, "b": b, "epilogue": epi, "ta": ta,
            "tb": tb, "m": m, "n": n, "k": k, "names": names,
            "resid": rand(gen, m, n, dtype=dt) if epi == "residual" else None,
            # the weight gradients' k-ranges, as gemm_split gives them
            "k_split": matmul.split(m, n, k, dt) if ta else None}


def run_mm(ops, plain=False):
    from xclip_tpu_torch.kernels import matmul
    fn = matmul.mm_plain if plain else matmul.mm
    return fn(ops["a"], ops["b"], ops["epilogue"], ops["ta"], ops["tb"],
              ops["resid"], ops["k_split"])


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare_products(label, got, want, names):
    """Each output of the product kernel against mm_plain's: bf16 at two
    ulps of its largest magnitude, fp32 (the sums in another order only:
    the operands are the same values) at 1e-4 of it."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        tol = (ulps2(w) if w.dtype == torch.bfloat16
               else 1e-4 * max(float(w.abs().max()), 2.0 ** -20))
        worst = max(worst, compare(f"{label} {name}", g, w, tol))
    return worst


def product_cost(ops):
    """(bytes: A, B, resid read and every output written once; FLOPs) of
    one product call."""
    m, n, k, epi = ops["m"], ops["n"], ops["k"], ops["epilogue"]
    it = ops["a"].element_size()
    width = 2 * n if epi.startswith("geglu") else n
    out = {"store": it, "residual": it, "geglu": 4, "geglu_triple": 4 + 2 * it,
           "geglu_h": 4 + 2 * it}.get(epi, 4)
    parts = (math.ceil(k / ops["k_split"]) if ops["k_split"] else 1)
    nbytes = (it * m * k + it * k * width + out * parts * m * n
              + (it * m * n if epi == "residual" else 0))
    return nbytes, 2 * m * width * k


def library_ms(ops):
    """(ms, what) of one PyTorch call for the product on the same operands:
    in fp32 torch.mm (TF32 off) or torch.addmm for 'residual'; in bf16
    torch.mm with out_dtype=float32 where the epilogue's output is fp32 and
    this PyTorch has it (else bf16 out), torch.addmm for 'residual',
    torch.mm in bf16 for 'store'; the split weight gradient as one unsplit
    product."""
    a = ops["a"].T if ops["ta"] else ops["a"]
    b = ops["b"].T if ops["tb"] else ops["b"]
    tag = "fp32" if a.dtype == torch.float32 else "bf16"
    if ops["epilogue"] == "residual":
        return (cuda_ms(lambda: torch.addmm(ops["resid"], a, b)),
                f"addmm {tag}")
    if a.dtype == torch.float32:
        return cuda_ms(lambda: torch.mm(a, b)), "mm fp32"
    if ops["epilogue"] != "store":
        try:
            torch.mm(a[:8], b, out_dtype=torch.float32)
            return (cuda_ms(lambda: torch.mm(a, b, out_dtype=torch.float32)),
                    "mm out_dtype=float32")
        except (TypeError, RuntimeError):
            pass
    return cuda_ms(lambda: torch.mm(a, b)), "mm bf16"


def products(gen, step_rows):
    """Phase 19: every product class of the b = 2048 step on the bf16
    product kernel, at the rows its call sites take a chunk at
    (`step_rows`: call site -> rows) and at 65,792 rows: against mm_plain
    (every epilogue of the GEGLU class), timed beside mm_plain and one
    PyTorch call, with its bound and TFLOP/s. Returns (errs, ms, costs,
    library) keyed by class, from each class's first call at 65,792 rows."""
    phase(19, "products", "bf16 product kernel vs mm_plain on the card")
    errs, ms, costs, library = {}, {}, {}, {}
    for cls in PRODUCT_CLASSES:
        key, title, epilogues = cls[:3]
        worst = 0.0
        for call, (_, site, *_) in enumerate(cls[5]):
            for rows in (step_rows[site], 256 * 257):
                for epi in (epilogues if call == 0 else epilogues[:1]):
                    ops = product_operands(gen, cls, rows, call, epi)
                    worst = max(worst, compare_products(
                        ops["tag"], as_tuple(run_mm(ops)),
                        as_tuple(run_mm(ops, plain=True)), ops["names"]))
                    if epi != epilogues[0]:
                        continue
                    kms = cuda_ms(lambda: run_mm(ops))
                    pms = cuda_ms(lambda: run_mm(ops, plain=True))
                    lms, lwhat = library_ms(ops)
                    cost = product_cost(ops)
                    b_ms, b_by = bound(*cost)
                    print(f"  {title}: {ops['tag']}: kernel {kms:.3f} ms "
                          f"({cost[1] / kms / 1e9:.1f} TFLOP/s, "
                          f"{b_ms / kms:.2f} of the bound), bound {b_ms:.3f}"
                          f" ms ({b_by}; FLOPs {cost[1] / BF16_PEAK * 1e3:.3f}"
                          f" ms, bytes {cost[0] / HBM * 1e3:.3f} ms), plain "
                          f"{pms:.3f} ms, torch {lwhat} {lms:.3f} ms "
                          f"({kms / lms:.2f}x)", flush=True)
                    if call == 0 and rows == 256 * 257:
                        ms[key], costs[key] = (kms, pms), cost
                        library[key] = lms
                    del ops
                    torch.cuda.empty_cache()
        errs[key] = worst
    return errs, ms, costs, library


def parent_library(parent):
    """The kernel library of the older checkout at `parent`, built from its
    own csrc/ into its own build/ directory, every entry point it has
    typed as this checkout's."""
    from xclip_tpu_torch.kernels import _build
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC = parent / "xclip_tpu_torch" / "csrc"
    _build.BUILD_DIR = parent / "build" / "xclip_tpu_torch"
    try:
        path = _build.build()
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    return typed_library(path, parent / "xclip_tpu_torch" / "kernels" /
                         "_build.py")


def typed_library(path, build_py=None):
    """The kernel library at `path`, loaded, every entry point it has typed
    as this checkout's. With `build_py` (the library's own `_build.py`),
    an entry point whose arguments there differ from this checkout's is
    left untyped: a call to it raises ctypes.ArgumentError (the wrappers
    pass a float) instead of passing shifted arguments."""
    from xclip_tpu_torch.kernels import _build
    signatures = _build._SIGNATURES
    if build_py is not None:
        spec = importlib.util.spec_from_file_location("parent_build",
                                                      build_py)
        theirs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(theirs)
        signatures = {k: v for k, v in signatures.items()
                      if theirs._SIGNATURES.get(k) == v}
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _build._RESTYPES.get(name,
                                                              ctypes.c_int)
    return lib


def f32_products(gen, parent=None):
    """Phase 19, fp32: every product class on the fp32 kernel, every call
    at F32_ROWS: against mm_plain (every epilogue of the GEGLU class; 1e-4
    of each output's largest magnitude), timed beside mm_plain, torch.mm /
    addmm in fp32 (TF32 off), its bound at 67 TFLOP/s and, with `parent`
    (an older checkout's library), the parent's kernel on the same
    operands (its own split-k ranges). Returns (errs, ms, costs, library,
    parent ms) keyed by (class, rows), from each class's first call."""
    from xclip_tpu_torch.kernels import _build
    phase(19, "products-fp32", "fp32 product kernel vs mm_plain on the card"
          + ("" if parent is None else ", beside the parent's"))
    errs, ms, costs, library, old = {}, {}, {}, {}, {}
    for cls in PRODUCT_CLASSES:
        key, title, epilogues = cls[:3]
        for rows in F32_ROWS:
            worst = 0.0
            for call in range(len(cls[5])):
                for epi in (epilogues if call == 0 else epilogues[:1]):
                    ops = product_operands(gen, cls, rows, call, epi,
                                           torch.float32)
                    worst = max(worst, compare_products(
                        ops["tag"], as_tuple(run_mm(ops)),
                        as_tuple(run_mm(ops, plain=True)), ops["names"]))
                    if epi != epilogues[0]:
                        continue
                    kms = cuda_ms(lambda: run_mm(ops))
                    pms = cuda_ms(lambda: run_mm(ops, plain=True))
                    lms, lwhat = library_ms(ops)
                    cost = product_cost(ops)
                    b_ms, b_by = bound(*cost, FP32_PEAK)
                    line = (f"  fp32 {title}: {ops['tag']}: kernel {kms:.3f}"
                            f" ms ({cost[1] / kms / 1e9:.1f} TFLOP/s, "
                            f"{b_ms / kms:.2f} of the bound), bound "
                            f"{b_ms:.3f} ms ({b_by}), plain {pms:.3f} ms, "
                            f"torch {lwhat} {lms:.3f} ms ({kms / lms:.2f}x)")
                    if parent is not None:
                        m, n, k = ops["m"], ops["n"], ops["k"]
                        prev = dict(ops, k_split=parent.xclip_mm_split(
                            0, m, n, k, 0) if ops["ta"] else None)
                        with mock.patch.object(_build, "library",
                                               lambda: parent):
                            pk = cuda_ms(lambda: run_mm(prev))
                        line += f", parent {pk:.3f} ms ({pk / kms:.2f}x)"
                        del prev
                    marks = [w for w, bad in (
                        ("under half its bound", b_ms / kms < 0.5),
                        ("slower than torch", kms > lms)) if bad]
                    print(line + (f" [{'; '.join(marks)}]" if marks else ""),
                          flush=True)
                    if call == 0:
                        ms[key, rows], costs[key, rows] = (kms, pms), cost
                        library[key, rows] = lms
                        if parent is not None:
                            old[key, rows] = pk
                    del ops
                    torch.cuda.empty_cache()
            errs[key, rows] = worst
    return errs, ms, costs, library, old


def expected_f32_products(ffb, mega, lean, b=256, n=33, online=2, target=2,
                          depth=6):
    """The fp32 product kernel's launches per phase 23 step, by instance:
    the SimSiam passes over fp32 views, `online` with gradients and
    `target` without, `depth` layers each, at b images of n rows. The
    targets take K-MEGA (qkv, proj) and K-FF (GEGLU, residual) once a
    layer. Stored routes: K2's forward qkv and proj, its backward dattn,
    dxn (A.B^T), dW_out, dW_qkv; K1's forward GEGLU-triple and residual,
    pass 1 dy and dxn, pass 2 dW_in and dW_out. Lean routes, per chunk: K3's
    forward qkv and proj, its backward their recompute and its four; K-FF-s
    GEGLU and residual; the FF recompute backward h, dy, dxn, dW_in,
    dW_out."""
    dt, rows = torch.float32, b * n
    S, AB, ABT, ATB = (("store", False, False), ("store_f32", False, False),
                       ("store_f32", False, True), ("store_f32", True, False))
    G, G3, GH, R = (("geglu", False, False), ("geglu_triple", False, False),
                    ("geglu_h", False, False), ("residual", False, False))
    count = dict.fromkeys((S, AB, ABT, ATB, G, G3, GH, R), 0)

    def add(times, calls):
        for inst, c in calls.items():
            count[inst] += times * c

    add(depth * target, {S: 1, AB: 1, G: 1, R: 1})
    if not lean:
        add(depth * online, {S: 1, AB: 1, ABT: 4, ATB: 4, G3: 1, R: 1})
        return count
    mf = len(mega.fwd_stats_spans(b, n, 512, 8, dt, False))
    mb = len(mega.bwd_recompute_spans(b, n, 512, 8, dt, False))
    ff = len(ffb.fwd_stats_spans(rows, 512, 2048, dt))
    fb = len(ffb.bwd_recompute_spans(rows, 512, 2048, dt))
    add(depth * online, {S: mf + mb, AB: mf + mb + fb, ABT: 2 * (mb + fb),
                         ATB: 2 * (mb + fb), G: ff, R: ff})
    return count


def expected_products(ffb, mega):
    """The bf16 product kernel's launches per b = 2048 memory-lean step, by
    instance, from the chunks the step's calls take (6 layers a tower):
    K-FF-s a GEGLU and a residual product per chunk; K3's forward qkv and
    proj per chunk; the FF recompute backward h, dy, dxn, dW_in, dW_out per
    chunk; K3's backward its qkv and proj recompute, dattn, dxn, dW_out,
    dW_qkv per chunk."""
    dt = torch.bfloat16
    ff_f = ff_b = mg_f = mg_b = 0
    for n in (257, 32):
        ff_f += len(ffb.fwd_stats_spans(2048 * n, 512, 2048, dt))
        ff_b += len(ffb.bwd_recompute_spans(2048 * n, 512, 2048, dt))
        mg_f += len(mega.fwd_stats_spans(2048, n, 512, 8, dt, False))
        mg_b += len(mega.bwd_recompute_spans(2048, n, 512, 8, dt, False))
    return {("store", False, False): 6 * (mg_f + mg_b),
            ("store_f32", False, False): 6 * (ff_b + mg_f + mg_b),
            ("store_f32", False, True): 6 * 2 * (ff_b + mg_b),
            ("store_f32", True, False): 6 * 2 * (ff_b + mg_b),
            ("geglu", False, False): 6 * ff_f,
            ("geglu_triple", False, False): 0,
            ("geglu_h", False, False): 0,
            ("residual", False, False): 6 * ff_f}


# The row kernels' modes (csrc/row_kernels.cuh; phase 20): (key, record
# name, kernel, mode, Pallas body replaced, [(form, rows, d)]), "R" rows
# the rows of one chunk at the call site named by the form (phase 19's
# step_rows); the first shape is the record's. Forms, as the callers give
# the inputs: "ff_bwd" and "geglu" fp32 dy; "pre" fp32 dy, v and resid of
# the storage dtype, xn written (the FF and megablock pre-LayerNorms);
# "mega_bwd" dy of the storage dtype and fp32 v (K3's out LayerNorm).
ROW_KERNELS = [
    ("rows_geglu_recompute", "GEGLU backward rows, recompute mode (FF "
     "recompute backward)", "geglu", "recompute",
     "xclip_tpu/kernels/fused_ff_block.py:369",
     [("ff_bwd", "R", 2048), ("ff_bwd", 256 * 257, 2048)]),
    ("rows_geglu_stored_h", "GEGLU backward rows, stored-h mode (K1-h pass "
     "1)", "geglu", "stored_h", "xclip_tpu/kernels/fused_ff_block.py:494",
     [("geglu", 256 * 257, 2048)]),
    ("rows_geglu_k8", "GEGLU backward rows, K8 mode (K8 backward)", "geglu",
     "k8", "xclip_tpu/kernels/fused_ff.py:75", [("geglu", 256 * 257, 2048)]),
    ("rows_ln_geglu", "LayerNorm backward rows, GEGLU mode (K1 pass 1)",
     "ln", "geglu", "xclip_tpu/kernels/fused_ff_block.py:585",
     [("geglu", 256 * 257, 2048)]),
    ("rows_ln_ln", "LayerNorm backward rows (every FF and megablock "
     "LayerNorm)", "ln", "ln", "xclip_tpu/kernels/_common.py:50",
     [("pre", 256 * 257, 512), ("mega_bwd", "R", 512)]),
]
ROW_OUTPUTS = {("geglu", "recompute"): ("dh", "y", "dg_part"),
               ("geglu", "k8"): ("dh", "dg_part"),
               ("geglu", "stored_h"): ("dh", "y", "dprod", "dh2", "dg_part"),
               ("ln", "ln"): ("out", "xn", "dg_part"),
               ("ln", "geglu"): ("dprod", "dh", "dh2", "y2", "dg_part")}


def row_inputs(gen, kernel, mode, form, rows, d, dtype):
    """(args, kwargs) of one row-kernel call as its callers give it:
    unit-scale rows, gains near 1, and the statistics of the values the
    rows normalise (the stored-h mode's from the fp32 h, as K1-h stores
    them, while h is rounded)."""
    from xclip_tpu_torch.kernels import _common as kc
    f32 = torch.float32
    g = 1 + rand(gen, d, scale=0.1, dtype=dtype)
    eps = kc.eps_for(dtype)
    if kernel == "geglu" or form == "geglu":
        h32 = rand(gen, rows, 2 * d)
        a, b, phi, gelu_b = kc.geglu_parts(h32)
        prod = a * gelu_b
        stats = tuple(s[:, 0] for s in kc.ln_stats_fp32(prod, eps))
    if kernel == "geglu":
        h = h32 if mode == "recompute" else h32.to(dtype)
        dy = rand(gen, rows, d, dtype=dtype if mode == "k8" else f32)
        return ((mode, dy, h, g), {"stats": None if mode == "k8" else stats})
    if form == "geglu":
        return (("geglu", rand(gen, rows, d), prod.to(dtype), g, stats),
                {"gb": gelu_b.to(dtype),
                 "agdb": (a * kc.gelu_grad(b, phi)).to(dtype)})
    pre = form == "pre"
    v = rand(gen, rows, d, dtype=dtype if pre else f32)
    stats = tuple(s[:, 0] for s in kc.ln_stats_fp32(v.float(), eps))
    dy = rand(gen, rows, d, dtype=f32 if pre else dtype)
    return (("ln", dy, v, g, stats),
            {"resid": rand(gen, rows, d, dtype=dtype) if pre else None,
             "xn_out": pre})


def rows_cost(kernel, mode, args, kw):
    """(bytes: every input read once, every output written once, the dg
    partials and g included; operations, erf and exp one each) of a call."""
    from xclip_tpu_torch.kernels import rows as rk
    dy, g = args[1], args[3]
    n, d = dy.shape
    it = g.element_size()
    ins = [t for t in (*args[1:3], *(args[4] if len(args) > 4 else
                                     kw.get("stats") or ()),
                       kw.get("resid"), kw.get("gb"), kw.get("agdb"))
           if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in ins) + d * it
    width = {("geglu", "recompute"): 3, ("geglu", "k8"): 2,
             ("geglu", "stored_h"): 4 + 2 * (it == 2),
             ("ln", "ln"): 1 + kw.get("xn_out", False),
             ("ln", "geglu"): 4 + 2 * (it == 2)}[(kernel, mode)]
    nbytes += width * n * d * it + rk.blocks(n) * d * 4
    return nbytes, n * d * (20 if kernel == "geglu" else 8)


def run_rows(kernel, args, kw, plain=False):
    from xclip_tpu_torch.kernels import rows as rk
    fn = {("geglu", False): rk.geglu_bwd_rows,
          ("geglu", True): rk.geglu_bwd_rows_plain,
          ("ln", False): rk.ln_bwd_rows,
          ("ln", True): rk.ln_bwd_rows_plain}[(kernel, plain)]
    return fn(*args, **kw)


def ln_library_ms(args):
    """ms of torch's own LayerNorm backward on the same rows:
    aten.native_layer_norm_backward on dy (cast to x's dtype outside the
    timing), x, mean, rstd and g; it computes dx and dg, without the
    residual add and xn."""
    _, dy, x, g, (mean, inv) = args
    dyx = dy.to(x.dtype)
    return cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        dyx, x, [x.shape[1]], mean[:, None], inv[:, None], g, None,
        [True, True, False]))


def rows_phase(gen, step_rows):
    """Phase 20: each mode of the two row kernels alone at the rows and
    widths its callers give it, fp32 and bf16, against its plain version
    (compare_products' tolerances), two launches bit for bit equal; bf16
    timed beside the plain version, the bound by bytes and, for the
    LayerNorm backward, torch's native_layer_norm_backward. Returns (errs,
    ms, costs, library) keyed by mode, from each mode's first shape."""
    phase(20, "rows", "LN-backward and GEGLU-backward row kernels vs plain "
          "version on the card")
    errs, ms, costs, library = {}, {}, {}, {}
    for key, title, kernel, mode, _, shapes in ROW_KERNELS:
        worst = 0.0
        for i, (form, rows, d) in enumerate(shapes):
            rows = step_rows[form] if rows == "R" else rows
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{str(dtype).split('.')[-1]} ({rows} x {d}, {form})"
                args, kw = row_inputs(gen, kernel, mode, form, rows, d, dtype)
                got = run_rows(kernel, args, kw)
                again = run_rows(kernel, args, kw)
                want = run_rows(kernel, args, kw, plain=True)
                trio = [(n, g, w) for n, g, w, a in zip(
                    ROW_OUTPUTS[(kernel, mode)], got, want, again)
                    if w is not None]
                if not all(torch.equal(g, a) for g, a in zip(got, again)
                           if g is not None):
                    fail(f"{title} {tag}: two launches differ")
                err = compare_products(f"{key} {tag}", *(
                    [t[j] for t in trio] for j in (1, 2, 0)))
                del got, again, want, trio
                if dtype == torch.float32:
                    continue
                worst = max(worst, err)
                kms = cuda_ms(lambda: run_rows(kernel, args, kw))
                pms = cuda_ms(lambda: run_rows(kernel, args, kw, plain=True))
                lms = ln_library_ms(args) if kernel == "ln" and mode == "ln" \
                    and form == "pre" else None
                cost = rows_cost(kernel, mode, args, kw)
                b_ms, b_by = bound(*cost, FP32_PEAK)
                print(f"  {title} {tag}: kernel {kms:.3f} ms "
                      f"({cost[0] / kms / 1e6:.0f} GB/s, {b_ms / kms:.2f} of "
                      f"the bound), bound {b_ms:.3f} ms ({b_by}), plain "
                      f"{pms:.3f} ms"
                      + (f", torch native_layer_norm_backward {lms:.3f} ms "
                         "(dx and dg only, no residual add, no xn)"
                         if lms is not None else ""), flush=True)
                if i == 0:
                    ms[key], costs[key], library[key] = (kms, pms), cost, lms
                del args, kw
                torch.cuda.empty_cache()
        errs[key] = worst
    return errs, ms, costs, library


# The LayerNorm forward rows' modes (csrc/row_kernels.cuh
# ln_fwd_rows_kernel; phase 20): (key, record name, mode, Pallas body
# replaced, [(input, rows, d)]), input "T" the storage dtype or "f32" as
# the mode's callers give it; the first shape is the record's. Every mode
# also runs at LN_FWD_WIDTHS.
LN_FWD_BODY = "xclip_tpu/kernels/_common.py:40"
LN_FWD_KERNELS = [
    ("ln_fwd_stats", "LayerNorm forward rows, stats mode (the training "
     "forwards' pre-LayerNorms, K-FF-s's and K1-h's inner)", "stats",
     LN_FWD_BODY, [("f32", 256 * 257, 2048), ("T", 256 * 257, 512)]),
    ("ln_fwd_residual", "LayerNorm forward rows, residual mode (the "
     "megablock's out LayerNorm)", "residual", LN_FWD_BODY,
     [("f32", 256 * 257, 512)]),
    ("ln_fwd_plain", "LayerNorm forward rows, plain mode (K-FF's and the "
     "recompute backwards' pre-LayerNorms)", "plain", LN_FWD_BODY,
     [("T", 256 * 257, 512)]),
    ("ln_fwd_in_copy", "LayerNorm forward rows, in_copy mode (K1's inner "
     "LayerNorm)", "in_copy", LN_FWD_BODY, [("f32", 256 * 257, 2048)]),
    ("ln_fwd_geglu", "LayerNorm forward rows, GEGLU mode (K8's forward)",
     "geglu", "xclip_tpu/kernels/fused_ff.py:68", [("T", 256 * 257, 2048)]),
]
LN_FWD_WIDTHS = (7, 96, 100, 160, 4100, 4104, 8192)
LN_FWD_OUTPUTS = {"plain": ("out",), "geglu": ("out",),
                  "stats": ("out", "mean", "inv"),
                  "residual": ("out", "mean", "inv"),
                  "in_copy": ("out", "mean", "inv", "in_copy")}


def ln_fwd_inputs(gen, mode, src, rows, d, dtype):
    """(mode, x, g, resid) of one LayerNorm-forward call as its callers
    give it: unit-scale rows (fp32 or of the storage dtype; [a, b] twice
    as wide for GEGLU), gains near 1, a residual of the storage dtype."""
    x = rand(gen, rows, 2 * d if mode == "geglu" else d,
             dtype=torch.float32 if src == "f32" else dtype)
    return (mode, x, 1 + rand(gen, d, scale=0.1, dtype=dtype),
            rand(gen, rows, d, dtype=dtype) if mode == "residual" else None)


def ln_fwd_cost(args):
    """(bytes: x, g and resid read once, out, the statistics and the copy
    written once; operations, erf one each) of one call."""
    mode, x, g, resid = args
    rows, d = x.shape[0], g.shape[0]
    it = g.element_size()
    nbytes = (x.numel() * x.element_size() + d * it + rows * d * it
              * (1 + (resid is not None) + (mode == "in_copy"))
              + 8 * rows * (len(LN_FWD_OUTPUTS[mode]) > 1))
    return nbytes, rows * d * (18 if mode == "geglu" else 8)


def ln_fwd_phase(gen):
    """Phase 20, forward: each LayerNorm forward mode alone at its callers'
    shapes and at LN_FWD_WIDTHS (77 rows), fp32 and bf16, against its plain
    version (compare_products' tolerances), two launches bit for bit
    equal; bf16 at the callers' shapes timed beside the plain version, the
    bound by bytes and, for the plain mode, F.layer_norm on the same rows
    (its output in the input's dtype, no statistics), for the stats mode
    torch.native_layer_norm on the same rows (out, mean and rstd; on fp32
    rows its out is fp32, where the kernel writes the storage dtype).
    Returns (errs, ms, costs, library) keyed by mode, from each mode's
    first shape."""
    from xclip_tpu_torch.kernels import rows as rk
    errs, ms, costs, library = {}, {}, {}, {}
    for key, title, mode, _, shapes in LN_FWD_KERNELS:
        worst = 0.0
        sweep = [(shapes[0][0], 77, w) for w in LN_FWD_WIDTHS]
        for i, (src, rows, d) in enumerate([*shapes, *sweep]):
            for dtype in (torch.float32, torch.bfloat16):
                tag = (f"{str(dtype).split('.')[-1]} ({rows} x {d}, "
                       f"{src} in)")
                args = ln_fwd_inputs(gen, mode, src, rows, d, dtype)
                got, again = rk.ln_rows(*args), rk.ln_rows(*args)
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    fail(f"{title} {tag}: two launches differ")
                err = compare_products(f"{key} {tag}", got,
                                       rk.ln_rows_plain(*args),
                                       LN_FWD_OUTPUTS[mode])
                del got, again
                if dtype == torch.float32 or i >= len(shapes):
                    continue
                worst = max(worst, err)
                kms = cuda_ms(lambda: rk.ln_rows(*args))
                pms = cuda_ms(lambda: rk.ln_rows_plain(*args))
                lms, x, g = None, args[1], args[2]
                if mode == "plain":
                    lms = cuda_ms(lambda: torch.nn.functional.layer_norm(
                        x, (d,), g, None, 1e-3))
                elif mode == "stats":
                    # out, mean and rstd from one call, the gain in the
                    # rows' dtype
                    gx = g.to(x.dtype)
                    lms = cuda_ms(lambda: torch.native_layer_norm(
                        x, (d,), gx, None, 1e-3))
                cost = ln_fwd_cost(args)
                b_ms, b_by = bound(*cost, FP32_PEAK)
                print(f"  {title} {tag}: kernel {kms:.4f} ms "
                      f"({cost[0] / kms / 1e6:.0f} GB/s, {b_ms / kms:.2f} of "
                      f"the bound), bound {b_ms:.4f} ms ({b_by}), plain "
                      f"{pms:.3f} ms"
                      + (f", torch {'F.layer_norm' if mode == 'plain' else
                                    'native_layer_norm'} {lms:.4f} ms"
                         if lms is not None else ""), flush=True)
                if i == 0:
                    ms[key], costs[key], library[key] = (kms, pms), cost, lms
                del args
                torch.cuda.empty_cache()
        errs[key] = worst
    return errs, ms, costs, library


# The ordered sums' call shapes (csrc/common.cuh launch_reduce_parts;
# phase 20): (key, record name, parts, width, acc, Pallas accumulator
# replaced); "R" parts: the dg partials of one FF recompute chunk of the
# b = 2048 step (phase 19's step_rows), acc 2 added to a running fp32 sum
# (the recompute backwards' chunks), acc 0 one bf16 sum over 65,792 rows
# (the stored backwards). The first six are the lean step's call sites,
# counted by (regime, width) in phase 11; 12 parts are one FF chunk's
# 2048-row k-ranges.
SUM_SHAPES = [
    ("sum_dg_inner", "ordered sum: dg of the inner LayerNorm (slab kernel)",
     "R", 2048, 2, "xclip_tpu/kernels/fused_ff_block.py:448"),
    ("sum_dg_dim", "ordered sum: dg of a model-width LayerNorm (slab "
     "kernel)", "R", 512, 2, "xclip_tpu/kernels/fused_ff_block.py:447"),
    ("sum_w_in", "ordered sum: split-k W_in gradient (wide kernel)", 12,
     512 * 4096, 2, "xclip_tpu/kernels/fused_ff_block.py:697"),
    ("sum_w_out", "ordered sum: split-k W_out gradient (wide kernel)", 12,
     2048 * 512, 2, "xclip_tpu/kernels/fused_ff_block.py:701"),
    ("sum_w_qkv", "ordered sum: split-k W_qkv gradient (wide kernel)", 12,
     512 * 1536, 2, "xclip_tpu/kernels/attention_megablock.py:552"),
    ("sum_w_proj", "ordered sum: split-k W_proj gradient (wide kernel)", 12,
     512 * 512, 2, "xclip_tpu/kernels/attention_megablock.py:525"),
    ("sum_dg_inner_stored", "", 1028, 2048, 0,
     "xclip_tpu/kernels/fused_ff_block.py:577"),
    ("sum_dg_dim_stored", "", 1028, 512, 0,
     "xclip_tpu/kernels/fused_ff_block.py:576"),
]
# the lean step's sum sites by (regime, width), as the library counts them
SUM_SITES = {"sum_dg_inner": ("sum", "slab", 2048),
             "sum_dg_dim": ("sum", "slab", 512),
             "sum_w_in": ("sum", "wide", 512 * 4096),
             "sum_w_out": ("sum", "wide", 2048 * 512),
             "sum_w_qkv": ("sum", "wide", 512 * 1536),
             "sum_w_proj": ("sum", "wide", 512 * 512)}


def reduce_phase(gen, step_rows):
    """Phase 20, the ordered sums (csrc/common.cuh launch_reduce_parts)
    alone at every call shape of SUM_SHAPES: bit for bit against the
    plain ordered sum (on the CPU) and between two launches, timed on
    cold copies of its inputs (cold_sets) beside its bytes bound (each
    partial read once from HBM, the running sum read and written once, or
    the bf16 sum written once), its plain version (the
    partials added one by one) and one PyTorch call, `part.sum(0)` (the
    same sum without the running one, in torch's own order) → (errs, ms,
    costs, library) by key."""
    from xclip_tpu_torch.kernels import rows as rk
    rows = step_rows["ff_bwd"]
    errs, ms, costs, library = {}, {}, {}, {}
    for key, _, parts, n, acc, _ in SUM_SHAPES:
        parts = rk.blocks(rows) if parts == "R" else parts
        part = rand(gen, parts, n)
        out = rand(gen, n)
        dtype = torch.bfloat16 if acc == 0 else torch.float32
        if acc == 2:
            got = rk.reduce_parts(part, out.clone())
            again = rk.reduce_parts(part, out.clone())
            want = rk.reduce_parts(part.cpu(), out.cpu())
        else:
            got = rk.reduce_parts(part, dtype=dtype)
            again = rk.reduce_parts(part, dtype=dtype)
            want = rk.reduce_parts(part.cpu(), dtype=dtype)
        if not torch.equal(got, want.to(got.device)):
            fail(f"reduce_parts {key}: not the plain ordered sum's bits")
        if not torch.equal(got, again):
            fail(f"reduce_parts {key}: two launches differ")
        errs[key] = 0.0
        # each call on its own cold copy of the partials (and of the
        # running sum): every byte comes from HBM, as the bound counts
        sets = cold_sets(*((part, out) if acc == 2 else (part,)))
        cold = itertools.cycle(sets)
        if acc == 2:
            def kernel():
                rk.reduce_parts(*next(cold))
        else:
            def kernel():
                rk.reduce_parts(next(cold)[0], dtype=dtype)

        def plain():
            p, *run = next(cold)
            total = run[0] if acc == 2 else p[0].clone()
            for x in (p if acc == 2 else p[1:]):
                total.add_(x)
            return total.to(dtype)

        def lib():
            next(cold)[0].sum(0)

        # the kernel and part.sum(0) back to back, a graph of one call on
        # each cold set (no host gap in which the L2 cache writes back
        # unseen; the plain version, a launch a partial, by the profiler)
        kms, library[key] = (graph_ms(f, len(sets)) for f in (kernel, lib))
        plain_ms = device_ms(plain, 3)
        events = cuda_ms(kernel)
        nbytes = (parts + 2) * n * 4 if acc == 2 else parts * n * 4 + n * (
            2 if acc == 0 else 4)
        costs[key] = (nbytes, parts * n)
        ms[key] = (kms, plain_ms)
        b_ms, _ = bound(*costs[key], FP32_PEAK)
        print(f"  ordered sums, {key}: {parts} partials x {n}, acc {acc}: "
              f"kernel {kms:.4f} ms back to back in a CUDA graph "
              f"({events:.4f} ms a call launched alone, the host's launch "
              f"included), bound {b_ms:.4f} ms "
              f"(bytes), {b_ms / kms:.2f} of the bound, plain "
              f"{plain_ms:.4f} ms, part.sum(0) {library[key]:.4f} ms "
              f"({kms / library[key]:.2f}x); bit for bit the plain ordered "
              f"sum, two launches equal", flush=True)
        del part, out, got, again, want, cold, sets
    torch.cuda.empty_cache()
    return errs, ms, costs, library


def expected_sums(ffb, mega, b):
    """The ordered sums' launches per memory-lean step at batch b by call
    site (SUM_SITES), from the chunks the step's calls take (6 layers a
    tower): the FF recompute backward a dg sum of the inner and of the pre
    LayerNorm and the split-k sums of W_in and W_out per chunk; K3's
    backward the dg sums of its out and pre LayerNorms and the split-k
    sums of W_proj and W_qkv per chunk."""
    dt = torch.bfloat16
    ff_b = mg_b = 0
    for n in (257, 32):
        ff_b += len(ffb.bwd_recompute_spans(b * n, 512, 2048, dt))
        mg_b += len(mega.bwd_recompute_spans(b, n, 512, 8, dt, False))
    return {"sum_dg_inner": 6 * ff_b, "sum_dg_dim": 6 * (ff_b + 2 * mg_b),
            "sum_w_in": 6 * ff_b, "sum_w_out": 6 * ff_b,
            "sum_w_qkv": 6 * mg_b, "sum_w_proj": 6 * mg_b}


def expected_ln_fwd(ffb, mega, b):
    """The LayerNorm forward rows' launches per memory-lean step at batch b
    (6 layers a tower): K-FF-s two in stats mode per chunk (pre and
    inner), the FF recompute backward one plain per chunk (xn), K3's
    forward one stats and one residual per chunk, K3's backward one plain
    per chunk (its recomputed xn; the out LayerNorm's statistics are the
    forward's)."""
    dt = torch.bfloat16
    fs = sum(len(ffb.fwd_stats_spans(b * n, 512, 2048, dt)) for n in (257, 32))
    fr = sum(len(ffb.bwd_recompute_spans(b * n, 512, 2048, dt))
             for n in (257, 32))
    ms = sum(len(mega.fwd_stats_spans(b, n, 512, 8, dt, False))
             for n in (257, 32))
    mb = sum(len(mega.bwd_recompute_spans(b, n, 512, 8, dt, False))
             for n in (257, 32))
    return {"rows_ln_fwd_plain": 6 * (fr + mb),
            "rows_ln_fwd_stats": 6 * (2 * fs + ms),
            "rows_ln_fwd_residual": 6 * ms}


def expected_rows(ffb, mega, b):
    """The row kernels' launches per memory-lean step at batch b (6 layers
    a tower): the FF recompute backward a GEGLU-backward (recompute mode)
    and a LayerNorm-backward launch per chunk, K3's backward two
    LayerNorm-backward launches per chunk."""
    dt = torch.bfloat16
    ff = sum(len(ffb.bwd_recompute_spans(b * n, 512, 2048, dt))
             for n in (257, 32))
    mg = sum(len(mega.bwd_recompute_spans(b, n, 512, 8, dt, False))
             for n in (257, 32))
    return {"rows_geglu_recompute": 6 * ff, "rows_ln_ln": 6 * (ff + 2 * mg)}


# Phase 21's small CLIPs (2 + 2 layers, 32 tokens, 16 patches): (label,
# CLIP kwargs beside HEADS_BASE, routes, launches per serving forward,
# launches per train step, dtype) with heads other than 64, and (label,
# CLIP kwargs, routes, the limit's words) past the CUDA kernels. The
# cases with heads of 128 in both towers give the 128-wide kernels'
# launches in the kernels line (WIDE_KERNELS).
HEADS_BASE = dict(dim_text=128, dim_image=128, dim_latent=64,
                  num_text_tokens=1000, text_enc_depth=2, text_seq_len=32,
                  text_heads=4, visual_enc_depth=2, visual_heads=2,
                  visual_image_size=64, visual_patch_size=16)
_K1 = {"k1_fwd": 4, "k1_p1": 4, "k1_p2": 4}
_FUSED = dict(attn_impl="fused", visual_attn_impl="fused",
              ff_impl="block_stored")
_MEGA = ({"mega": 4, "kff": 4}, {"k2_fwd": 4, "k2_bwd": 4, **_K1})
_K6 = ({"mega": 2, "k6_fwd": 2, "kff": 4},
       {"k2_fwd": 2, "k2_bwd": 2, "k6_fwd": 2, "k6_bwd": 2, **_K1})
_K7 = ({"k7_fwd": 4, "kff": 4}, {"k7_fwd": 4, "k7_bwd": 4, **_K1})
_WIDE = dict(text_dim_head=128, visual_dim_head=128)
BF16, F32 = torch.bfloat16, torch.float32
_FLASH = dict(attn_impl="flash", ff_impl="block_stored")
NARROW_HEADS = [
    ("text dim_head 32 (true width), 'fused'", dict(text_dim_head=32),
     _FUSED, *_MEGA, BF16),
    ("text dim_head 32 (true width), rotary, 'fused' (K6)",
     dict(text_dim_head=32, text_rotary_pos_emb=True), _FUSED, *_K6, BF16),
    ("text dim_head 32 (true width), 'flash'", dict(text_dim_head=32),
     _FLASH, *_K7, BF16),
    ("text dim_head 128, 'flash'", dict(text_dim_head=128), _FLASH, *_K7,
     BF16),
    ("dim_head 128, 'fused'", _WIDE, _FUSED, *_MEGA, BF16),
    ("visual 4 x dim_head 80 (true width), 'fused'",
     dict(visual_dim_head=80, visual_heads=4), _FUSED, *_MEGA, BF16),
    ("visual 2 x dim_head 80 (padded to 96), 'fused'",
     dict(visual_dim_head=80), _FUSED, *_MEGA, BF16),
    ("text dim_head 256, visual 192, 'fused'",
     dict(text_dim_head=256, visual_dim_head=192), _FUSED, *_MEGA, BF16),
    ("text dim_head 256, rotary, 'fused' (K6)",
     dict(text_dim_head=256, text_rotary_pos_emb=True), _FUSED, *_K6, BF16),
    ("text dim_head 192, visual 256, 'flash'",
     dict(text_dim_head=192, visual_dim_head=256), _FLASH, *_K7, BF16),
    ("dim_head 128, rotary, 'fused' (K6)",
     dict(_WIDE, text_rotary_pos_emb=True), _FUSED, *_K6, BF16),
    ("fp32 dim_head 128, 'fused'", _WIDE, _FUSED, *_MEGA, F32),
    ("fp32 dim_head 128, rotary, 'fused' (K6)",
     dict(_WIDE, text_rotary_pos_emb=True), _FUSED, *_K6, F32),
    ("fp32 dim_head 128, 'flash'", _WIDE, _FLASH, *_K7, F32),
]
# The NARROW_HEADS cases whose heads the megablock takes only padded (2
# heads of 80 are 160 columns, off its 64-column grid): label → (dim_head,
# the width `pad_heads` gives them). Every other case runs its heads as
# they are, with no `pad_heads` call.
PADDED_HEADS = {"visual 2 x dim_head 80 (padded to 96), 'fused'": (80, 96)}
PAST_KERNELS = [  # (label, CLIP kwargs, routes, the limit's words, dtype)
    ("text dim_head 264, 'fused'", dict(text_dim_head=264), _FUSED,
     "not 264", BF16),
    ("fp32 text dim_head 192, 'fused'", dict(text_dim_head=192), _FUSED,
     "not 192", F32),
    ("text FF inner 288 (dim 72), 'block'", dict(dim_text=72, text_heads=2),
     dict(attn_impl="xla", ff_impl="block"), "not dim 72, inner 288", BF16),
]


def narrow_wrappers():
    """Phase 21's wrapper checks: K-MEGA, K2 (output and gradients), K6 and
    K7 at dim_head 32, fp32, on the card against their plain versions at
    the true width on the CPU (K7's: SDPA) → [line]."""
    from xclip_tpu_torch.kernels import attention_block as core
    from xclip_tpu_torch.kernels import attention_megablock as mega
    from xclip_tpu_torch.kernels import flash_attention as flash
    gen = torch.Generator(device="cuda").manual_seed(210)
    b, n, heads, d, dim = 4, 77, 4, 32, 128
    scale = d ** -0.5
    mask = key_mask([77, 50, 13, 1], n)
    x = rand(gen, b, n, dim)
    g = 1 + rand(gen, dim, scale=0.1)
    w_qkv = rand(gen, dim, 3 * heads * d, scale=dim ** -0.5)
    w_out = rand(gen, heads * d, dim, scale=(heads * d) ** -0.5)
    qkv = rand(gen, b, n, 3 * heads * d)
    q, k, v = (rand(gen, b, heads, n, d) for _ in range(3))
    cpu = [t.cpu() for t in (x, g, w_qkv, w_out, mask, qkv, q, k, v)]
    before = (mega.attention_block.launches, mega.attention_block_bwd.launches,
              core.attention_core_fwd.launches,
              flash.flash_attention_fwd.launches)
    out = {}
    for dev, (xx, gg, wq, wo, mm, qq, q1, k1, v1) in (
            ("cuda", (x, g, w_qkv, w_out, mask, qkv, q, k, v)),
            ("cpu", cpu)):
        # on the card the wrappers; on the CPU the plain versions at d
        kernel = dev == "cuda"
        leaves = [t.clone().requires_grad_(True) for t in (xx, wq, wo)]
        with torch.no_grad():
            mega_out = (mega.attention_block if kernel else
                        mega.attention_block_plain)(xx, gg, wq, wo, gg, mm,
                                                    heads, d, scale)
        k2 = (mega.attention_block_train if kernel else
              mega.attention_block_plain)(leaves[0], gg, leaves[1],
                                          leaves[2], gg, mm, heads, d, scale)
        grads = torch.autograd.grad(k2, leaves, torch.ones_like(k2))
        with torch.no_grad():
            k6 = (core.attention_core(qq, mm, heads, d, scale) if kernel else
                  core.attention_core_fwd_plain(qq, mm, heads, d, scale)[0])
            k7 = (flash.flash_attention(q1, k1, v1, mm) if kernel else
                  torch.nn.functional.scaled_dot_product_attention(
                      q1, k1, v1, attn_mask=mm[:, None, None, :], scale=1.0))
        out[dev] = [mega_out, k2.detach(), *grads, k6, k7]
    after = (mega.attention_block.launches, mega.attention_block_bwd.launches,
             core.attention_core_fwd.launches,
             flash.flash_attention_fwd.launches)
    if any(a != b_ + 1 for a, b_ in zip(after, before)):
        fail(f"dim_head 32 wrappers: launches {after} after {before}, "
             "expected one each")
    lines = []
    for name, got, want in zip(("K-MEGA", "K2 out", "K2 dx", "K2 dw_qkv",
                                "K2 dw_out", "K6", "K7"), out["cuda"],
                               out["cpu"]):
        err = compare(f"dim_head 32 {name}", got.cpu(), want,
                      1e-4 * float(want.abs().max()))
        lines.append(f"{name} {err:.2e}")
    # K7 in bf16 on heads of 128 (two 64-column halves): the kernels alone
    # against their plain versions (phase 12's rule), timed beside them,
    # their bound and SDPA; then a head of 96 through `flash_attention`,
    # zero-padded to 128, against the plain forward at 96
    bf16, bh, n, h = torch.bfloat16, 512, 256, 8
    lengths = [n // 2 + (37 * i) % (n // 2 + 1) for i in range(bh // h)]
    mask_bh = key_mask([L for L in lengths for _ in range(h)], n)
    q, k, v, do = (rand(gen, bh, n, 128, scale=128 ** -0.25 if i < 2 else 1.0,
                        dtype=bf16) for i in range(4))
    fwd = flash.flash_attention_fwd(q, k, v, mask_bh, True)
    want = flash.flash_attention_fwd_plain(q, k, v, mask_bh, True)
    e_fwd = compare_elementwise("K7 dim_head 128", ("out", "lse"), fwd, want,
                                bf16)
    bwd_args = (q, k, v, mask_bh, *want, do, True)
    e_bwd = compare_elementwise(
        "K7 dim_head 128", ("dq", "dk", "dv"),
        flash.flash_attention_bwd(*bwd_args),
        flash.flash_attention_bwd_plain(*bwd_args), bf16)
    ms = [cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, mask_bh, True)),
          cuda_ms(lambda: flash.flash_attention_bwd(*bwd_args)),
          cuda_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, mask_bh,
                                                          True)),
          cuda_ms(lambda: flash.flash_attention_bwd_plain(*bwd_args),
                  reps=3, iters=1)]
    b4 = [t.reshape(bh // h, h, n, 128) for t in (q, k, v, do)]
    sdpa = sdpa_ms(*b4[:3], key_mask(lengths, n), True, 1.0, b4[3])
    bounds = [bound(*flash_cost(kind, bh, n, [L for L in lengths
                                              for _ in range(h)],
                                True, width=128))[0]
              for kind in ("fwd", "bwd")]
    print(f"  K7 dim_head 128 (b*h {bh}, n {n}, causal, bf16): forward "
          f"{ms[0]:.4f} ms (bound {bounds[0]:.4f}, plain {ms[2]:.4f}, sdpa "
          f"{sdpa[0]:.4f}), backward {ms[1]:.4f} ms (bound {bounds[1]:.4f},"
          f" plain {ms[3]:.4f}, sdpa {sdpa[1]:.4f})", flush=True)
    lines.append(f"K7 dim_head 128 out/lse {e_fwd:.2e}, grads {e_bwd:.2e}, "
                 f"{ms[0]:.3f} / {ms[1]:.3f} ms")
    q4, k4, v4 = (rand(gen, 4, 2, 77, 96, scale=96 ** -0.25 if i < 2
                       else 1.0, dtype=bf16) for i in range(3))
    m4 = key_mask([77, 50, 13, 1], 77)
    before96 = flash.flash_attention_fwd.launches
    got = flash.flash_attention(q4, k4, v4, m4, causal=True)
    if flash.flash_attention_fwd.launches != before96 + 1:
        fail("K7 dim_head 96: no kernel launch")
    (qf, kf, vf), mf = flash.pad_flat((q4, k4, v4), m4)
    want = flash.flash_attention_fwd_plain(qf, kf, vf, mf, True)[0]
    e96 = compare_elementwise(
        "K7 dim_head 96 (padded to 128)", ("out",),
        (got.reshape(8, 77, 96),), (want[:, :77],), bf16)
    lines.append(f"K7 dim_head 96 out {e96:.2e}")
    return lines


# The 128-wide kernels alone (phase 21): (key, the NARROW_HEADS case
# whose serving and train step give the launches, its counter, record
# name, source, Pallas body replaced), timed at the text tower's shapes
# with 4 heads of 128 (hd 512, the flagship's 8 x 64)
WIDE_KERNELS = [
    ("mega_bf16_fwd", "dim_head 128, 'fused'", "core_fwd",
     "megablock attention core forward, heads of 128 (two 64-column halves)",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_megablock.py:158"),
    ("mega_bf16_bwd", "dim_head 128, 'fused'", "core_bwd",
     "megablock attention core backward (dq, dk/dv), heads of 128",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_megablock.py:396"),
    ("mega_f32_fwd", "fp32 dim_head 128, 'fused'", "core_fwd",
     "megablock attention core forward, fp32, heads of 128",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_megablock.py:158"),
    ("mega_f32_bwd", "fp32 dim_head 128, 'fused'", "core_bwd",
     "megablock attention core backward (dq, dk/dv), fp32, heads of 128",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_megablock.py:396"),
    ("k6_bf16_fwd", "dim_head 128, rotary, 'fused' (K6)", "k6_fwd",
     "K6 attention_core forward, heads of 128",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_block.py:83"),
    ("k6_bf16_bwd", "dim_head 128, rotary, 'fused' (K6)", "k6_bwd",
     "K6 attention_core backward (dq, dk/dv), heads of 128",
     "xclip_tpu_torch/csrc/attention_block_sm90.cuh",
     "xclip_tpu/kernels/attention_block.py:117"),
    ("k6_f32_fwd", "fp32 dim_head 128, rotary, 'fused' (K6)", "k6_fwd",
     "K6 attention_core forward, fp32, heads of 128",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_block.py:83"),
    ("k6_f32_bwd", "fp32 dim_head 128, rotary, 'fused' (K6)", "k6_bwd",
     "K6 attention_core backward (dq, dk/dv), fp32, heads of 128",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/attention_block.py:117"),
    ("k7_f32_fwd", "fp32 dim_head 128, 'flash'", "k7_fwd",
     "K7 flash_attention forward, fp32, heads of 128: the core's K7 mode",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/flash_attention.py:66"),
    ("k7_f32_bwd", "fp32 dim_head 128, 'flash'", "k7_bwd",
     "K7 flash_attention backward (dq, dk/dv), fp32, heads of 128",
     "xclip_tpu_torch/csrc/attention_core.cuh",
     "xclip_tpu/kernels/flash_attention.py:134"),
]


# warps an SM each bf16 kernel at heads of 128 (K6's and the megablock's
# forward, dq and dk/dv) is built for: two blocks of four (phase 21 fails
# under them)
WIDE_BF16_WARPS = 8


def wide_kernels():
    """Phase 21's 128-wide kernels alone, from a generator of their own:
    the megablock's core (256, 257, 3 x 512, not causal) and K6 (256, 256,
    causal), 4 heads of 128 with key pads, in bf16 and fp32, and fp32 K7
    (b*h 512, n 256, 128, causal, key pads): forward, and backward (the dq
    and dk/dv kernels), against their plain versions element by element
    (phase 12's rule), two backward launches (fp32: and two forward
    launches) bit for bit equal; the fp32 kernels' blocks and warps an SM
    at heads of 128 (one block of two 256-thread halves: 16 warps, as two
    blocks at 64), and the bf16 kernels' (at least WIDE_BF16_WARPS); the
    backward's dq and dk/dv kernels timed apart on the device; timed
    beside their plain versions, SDPA on the same q, k, v and mask (in
    the same dtype) and their bounds (bf16 by bytes at 3.35 TB/s or bf16
    FLOPs; fp32 FMAs at 67 TFLOP/s). Returns (errs, ms, costs, library,
    peaks) keyed as WIDE_KERNELS."""
    from xclip_tpu_torch.kernels import attention_block as core
    from xclip_tpu_torch.kernels import attention_megablock as mega
    from xclip_tpu_torch.kernels import flash_attention as flash
    from xclip_tpu_torch.kernels import _build
    wgen = torch.Generator(device="cuda").manual_seed(211)
    errs, ms, costs, library, peaks = {}, {}, {}, {}, {}
    b, heads, d = 256, 4, 128
    hd, scale = heads * d, d ** -0.5
    lib = _build.library()
    for mode, name in ((0, "megablock"), (1, "K6"), (2, "K7")):
        blocks = ((lib.xclip_flash_fwd_blocks(d),
                   *(lib.xclip_flash_bwd_blocks(w, d) for w in (0, 1)))
                  if mode == 2 else
                  (lib.xclip_attention_fwd_blocks(0, mode, d, 0),
                   *(lib.xclip_attention_bwd_blocks(0, mode, w, d, 0)
                     for w in (0, 1))))
        print(f"  fp32 {name} at heads of {d}, blocks (warps) an SM: "
              + ", ".join(f"{k} {n} ({16 * n})" for k, n in
                          zip(("forward", "dq", "dk/dv"), blocks)),
              flush=True)
        if blocks != (1, 1, 1):
            fail(f"fp32 {name} at heads of {d}: blocks an SM {blocks}, "
                 "not one 512-thread block (16 warps)")
    # the bf16 kernels at 128 as their launches configure them: K6's and
    # the megablock's forward, dq and dk/dv, each at least the warps an SM
    # its design is built for
    for mode, name in ((0, "megablock"), (1, "K6")):
        res = [(lib.xclip_attention_fwd_blocks(1, mode, d, 0),
                lib.xclip_attention_fwd_blocks(1, mode, d, 1)),
               *((lib.xclip_attention_bwd_blocks(1, mode, w, d, 0),
                  lib.xclip_attention_bwd_blocks(1, mode, w, d, 1))
                 for w in (0, 1))]
        print(f"  bf16 {name} at heads of {d}, blocks (warps) an SM: "
              + ", ".join(f"{k} {nb} ({nw})" for k, (nb, nw) in
                          zip(("forward", "dq", "dk/dv"), res)), flush=True)
        for k, (nb, nw) in zip(("forward", "dq", "dk/dv"), res):
            if nw < WIDE_BF16_WARPS:
                fail(f"bf16 {name} {k} at heads of {d}: {nb} blocks, {nw} "
                     f"warps an SM, under its design's {WIDE_BF16_WARPS}")

    def record(key, label, e, kms, cost, sdpa, peak):
        errs[key], ms[key], costs[key] = e, kms, cost
        library[key], peaks[key] = sdpa, peak
        b_ms, b_by = bound(*cost, peak)
        print(f"  {label} {key[-3:]}: kernel {kms[0]:.4f} ms "
              f"({kms[0] / sdpa:.2f}x sdpa), plain {kms[1]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), sdpa {sdpa:.4f} ms", flush=True)

    for dt in (BF16, F32):
        tag = "bf16" if dt == BF16 else "f32"
        peak = BF16_PEAK if dt == BF16 else FP32_PEAK
        for fam, n, causal in (("mega", 257, False), ("k6", 256, True)):
            lengths = torch.randint(1, n + 1, (b,), generator=wgen,
                                    device="cuda").tolist()
            mask = key_mask(lengths, n)
            qkv = rand(wgen, b, n, 3 * hd, dtype=dt)
            static = (heads, d, scale, causal, True)
            if fam == "mega":
                fwd, bwd = mega.mega_core_fwd, mega.mega_core_bwd
                fwd_plain = mega.mega_core_fwd_plain
                bwd_plain = mega.mega_core_bwd_plain
                cot, names = rand(wgen, b, n, hd), ("attnout", "sm")
            else:
                fwd, bwd = core.attention_core_fwd, core.attention_core_bwd
                fwd_plain = core.attention_core_fwd_plain
                bwd_plain = core.attention_core_bwd_plain
                cot, names = rand(wgen, b, n, hd, dtype=dt), ("out", "lse")
            label = (f"{fam} {tag} ({b}, {n}, 3x{hd}) {heads}x{d} "
                     f"{'causal ' if causal else ''}key-pad")
            want = fwd_plain(qkv, mask, *static)
            got = fwd(qkv, mask, *static)
            if dt == F32 and not all(map(torch.equal, got,
                                         fwd(qkv, mask, *static))):
                fail(f"{label}: two forward launches differ")
            e_fwd = compare_elementwise(label, names, got, want, dt)
            bargs = ((qkv, mask, cot, *want) if fam == "mega"
                     else (qkv, mask, *want, cot))
            got = bwd(*bargs, *static)
            if not torch.equal(got, bwd(*bargs, *static)):
                fail(f"{label}: two backward launches differ")
            e_bwd = compare_elementwise(label, ("dqkv",), (got,),
                                        (bwd_plain(*bargs, *static),), dt)
            del got
            q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(
                b, n, heads, d).transpose(1, 2) for i in range(3))
            sdpa = sdpa_ms(q, k, v, mask, causal, scale,
                           cot.to(dt).reshape(b, n, heads, d).transpose(1, 2))
            pairs = heads * valid_pairs(lengths, n, causal)
            keys = heads * used_keys(lengths, n)
            cost = mega_core_cost if fam == "mega" else core_cost
            for kind, e, fn, plain in (
                    ("fwd", e_fwd, lambda: fwd(qkv, mask, *static),
                     lambda: fwd_plain(qkv, mask, *static)),
                    ("bwd", e_bwd, lambda: bwd(*bargs, *static),
                     lambda: bwd_plain(*bargs, *static))):
                record(f"{fam}_{tag}_{kind}", label, e,
                       (cuda_ms(fn), cuda_ms(plain, reps=3, iters=1)),
                       cost(kind, b * n * heads, keys, pairs, b * n,
                            qkv.element_size(), width=d),
                       sdpa[0 if kind == "fwd" else 1], peak)
            # the backward's two kernels apart, on the device's clock
            split = backward_split(lambda: bwd(*bargs, *static))
            print(f"  {label} bwd: dq {split[0]:.4f} ms, dk/dv "
                  f"{split[1]:.4f} ms (device)", flush=True)
            del qkv, cot, want, bargs, q, k, v
            torch.cuda.empty_cache()
    # fp32 K7 on heads of 128 (bf16's are timed in narrow_wrappers)
    bh, n, h = 512, 256, 8
    lengths = [n // 2 + (37 * i) % (n // 2 + 1) for i in range(bh // h)]
    per_row = [L for L in lengths for _ in range(h)]
    mask_bh = key_mask(per_row, n)
    q, k, v, do = (rand(wgen, bh, n, d, scale=d ** -0.25 if i < 2 else 1.0)
                   for i in range(4))
    label = f"K7 f32 (b*h {bh}, n {n}, {d}) causal key-pad"
    want = flash.flash_attention_fwd_plain(q, k, v, mask_bh, True)
    bwd_args = (q, k, v, mask_bh, *want, do, True)
    got = [(flash.flash_attention_fwd(q, k, v, mask_bh, True),
            flash.flash_attention_bwd(*bwd_args)) for _ in range(2)]
    for i, which in enumerate(("forward", "backward")):
        if not all(map(torch.equal, got[0][i], got[1][i])):
            fail(f"{label}: two {which} launches differ")
    e_fwd = compare_elementwise(label, ("out", "lse"), got[0][0], want, F32)
    e_bwd = compare_elementwise(
        label, ("dq", "dk", "dv"), got[0][1],
        flash.flash_attention_bwd_plain(*bwd_args), F32)
    del got
    b4 = [t.reshape(bh // h, h, n, d) for t in (q, k, v, do)]
    sdpa = sdpa_ms(*b4[:3], key_mask(lengths, n), True, 1.0, b4[3])
    for kind, e, fn, plain in (
            ("fwd", e_fwd,
             lambda: flash.flash_attention_fwd(q, k, v, mask_bh, True),
             lambda: flash.flash_attention_fwd_plain(q, k, v, mask_bh,
                                                     True)),
            ("bwd", e_bwd, lambda: flash.flash_attention_bwd(*bwd_args),
             lambda: flash.flash_attention_bwd_plain(*bwd_args))):
        record(f"k7_f32_{kind}", label, e,
               (cuda_ms(fn), cuda_ms(plain, reps=3, iters=1)),
               flash_cost(kind, bh, n, per_row, True, it=4, width=d),
               sdpa[0 if kind == "fwd" else 1], FP32_PEAK)
    del q, k, v, do, want, bwd_args, b4
    torch.cuda.empty_cache()
    return errs, ms, costs, library, peaks


# The bf16 kernels at heads of 192 and 256 (three and four 64-column
# halves), alone (phase 21): (key, the NARROW_HEADS case whose serving and
# train step give the launches, record name, source, Pallas body replaced);
# launches counted by head width (`width_spies`). K6 at 192 is timed and
# printed but not recorded: JAX's routing sends heads of 192 to its XLA
# path (not a multiple of 128), so no main path launches it.
_TRUE_WIDTH_FAMILIES = {  # family: (title, source, Pallas bodies)
    "mega": ("megablock attention core", "attention_block_sm90.cuh",
             ("attention_megablock.py:158", "attention_megablock.py:396")),
    "k6": ("K6 attention_core", "attention_block_sm90.cuh",
           ("attention_block.py:83", "attention_block.py:117")),
    "k7": ("K7 flash_attention", "flash_attention_sm90.cuh",
           ("flash_attention.py:66", "flash_attention.py:134")),
}
TRUE_WIDTH_KERNELS = [
    (f"{fam}_{d}_{kind}", case,
     f"{_TRUE_WIDTH_FAMILIES[fam][0]} "
     f"{'forward' if kind == 'fwd' else 'backward (dq, dk/dv)'}, bf16 "
     f"heads of {d} ({d // 64} halves)",
     f"xclip_tpu_torch/csrc/{_TRUE_WIDTH_FAMILIES[fam][1]}",
     f"xclip_tpu/kernels/{_TRUE_WIDTH_FAMILIES[fam][2][kind == 'bwd']}")
    for fam, d, case in (
        ("mega", 256, "text dim_head 256, visual 192, 'fused'"),
        ("mega", 192, "text dim_head 256, visual 192, 'fused'"),
        ("k6", 256, "text dim_head 256, rotary, 'fused' (K6)"),
        ("k7", 256, "text dim_head 192, visual 256, 'flash'"),
        ("k7", 192, "text dim_head 192, visual 256, 'flash'"))
    for kind in ("fwd", "bwd")]
# the wrappers' checks whose calls are one launch each: (family, kind)
WIDTH_CHECKS = {
    "attention_block": ("mega", "fwd"),
    "attention_block_fwd_stored": ("mega", "fwd"),
    "attention_block_bwd": ("mega", "bwd"),
    "attention_core_fwd": ("k6", "fwd"), "attention_core_bwd": ("k6", "bwd"),
    "flash_attention_fwd": ("k7", "fwd"), "flash_attention_bwd": ("k7", "bwd"),
}


def width_spies(widths, pads):
    """Patches that count each attention wrapper's launches by head width
    into `widths` ((family, kind, width) → launches) and record each
    `pad_heads` call's dim_head into `pads`."""
    from xclip_tpu_torch.kernels import attention_block as core
    from xclip_tpu_torch.kernels import attention_megablock as mega
    from xclip_tpu_torch.kernels import flash_attention as flash

    def counting(check, width_of):
        def spy(name, *a, **kw):
            if name in WIDTH_CHECKS:
                widths[(*WIDTH_CHECKS[name], width_of(a))] += 1
            return check(name, *a, **kw)
        return spy

    pad_heads = mega.pad_heads

    def spy_pad(*a, **kw):
        pads.append(a[1])
        return pad_heads(*a, **kw)

    return [mock.patch.object(mega, "_check", counting(mega._check,
                                                       lambda a: a[3])),
            mock.patch.object(core, "_check", counting(core._check,
                                                       lambda a: a[3])),
            mock.patch.object(flash, "_check", counting(
                flash._check, lambda a: a[0][0].shape[-1])),
            mock.patch.object(mega, "pad_heads", spy_pad),
            mock.patch.object(core, "pad_heads", spy_pad)]


def true_width_kernels():
    """Phase 21's bf16 kernels at heads of 192 and 256, from a generator of
    their own: K6 (256, 256, 2 x d, causal), the megablock's core (256,
    257, 2 x d, not causal), both with key pads, and K7 (b*h 512, n 256, d,
    causal, key pads): forward and backward against their plain versions
    element by element (phase 12's rule), two backward launches bit for bit
    equal, each kernel's blocks (warps) an SM; timed beside the plain
    version, SDPA in bf16 on the same q, k, v and mask, and the bound.
    Returns (errs, ms, costs, library) keyed as TRUE_WIDTH_KERNELS (K6 at
    192 too)."""
    from xclip_tpu_torch.kernels import attention_block as core
    from xclip_tpu_torch.kernels import attention_megablock as mega
    from xclip_tpu_torch.kernels import flash_attention as flash
    from xclip_tpu_torch.kernels import _build
    tgen = torch.Generator(device="cuda").manual_seed(212)
    lib = _build.library()
    errs, ms, costs, library = {}, {}, {}, {}
    b, heads = 256, 2
    for d in (192, 256):
        for mode, name in ((0, "megablock"), (1, "K6")):
            res = [(lib.xclip_attention_fwd_blocks(1, mode, d, 0),
                    lib.xclip_attention_fwd_blocks(1, mode, d, 1)),
                   *((lib.xclip_attention_bwd_blocks(1, mode, w, d, 0),
                      lib.xclip_attention_bwd_blocks(1, mode, w, d, 1))
                     for w in (0, 1))]
            print(f"  bf16 {name} at heads of {d}, blocks (warps) an SM: "
                  + ", ".join(f"{k} {nb} ({nw})" for k, (nb, nw) in
                              zip(("forward", "dq", "dk/dv"), res)),
                  flush=True)
            if any(nb < 1 for nb, _ in res):
                fail(f"bf16 {name} at heads of {d}: blocks an SM {res}")
        hd, scale = heads * d, d ** -0.5
        for fam, n, causal in (("mega", 257, False), ("k6", 256, True)):
            lengths = torch.randint(1, n + 1, (b,), generator=tgen,
                                    device="cuda").tolist()
            mask = key_mask(lengths, n)
            qkv = rand(tgen, b, n, 3 * hd, dtype=BF16)
            static = (heads, d, scale, causal, True)
            if fam == "mega":
                fwd, bwd = mega.mega_core_fwd, mega.mega_core_bwd
                fwd_plain = mega.mega_core_fwd_plain
                bwd_plain = mega.mega_core_bwd_plain
                cot, names = rand(tgen, b, n, hd), ("attnout", "sm")
            else:
                fwd, bwd = core.attention_core_fwd, core.attention_core_bwd
                fwd_plain = core.attention_core_fwd_plain
                bwd_plain = core.attention_core_bwd_plain
                cot, names = rand(tgen, b, n, hd, dtype=BF16), ("out", "lse")
            label = (f"{fam} bf16 ({b}, {n}, 3x{hd}) {heads}x{d} "
                     f"{'causal ' if causal else ''}key-pad")
            want = fwd_plain(qkv, mask, *static)
            e_fwd = compare_elementwise(label, names, fwd(qkv, mask, *static),
                                        want, BF16)
            bargs = ((qkv, mask, cot, *want) if fam == "mega"
                     else (qkv, mask, *want, cot))
            got = bwd(*bargs, *static)
            if not torch.equal(got, bwd(*bargs, *static)):
                fail(f"{label}: two backward launches differ")
            e_bwd = compare_elementwise(label, ("dqkv",), (got,),
                                        (bwd_plain(*bargs, *static),), BF16)
            del got
            q, k, v = (qkv[..., i * hd:(i + 1) * hd].reshape(
                b, n, heads, d).transpose(1, 2) for i in range(3))
            sdpa = sdpa_ms(q, k, v, mask, causal, scale,
                           cot.to(BF16).reshape(b, n, heads, d)
                           .transpose(1, 2))
            pairs = heads * valid_pairs(lengths, n, causal)
            keys = heads * used_keys(lengths, n)
            cost = mega_core_cost if fam == "mega" else core_cost
            for kind, e, fn, plain in (
                    ("fwd", e_fwd, lambda: fwd(qkv, mask, *static),
                     lambda: fwd_plain(qkv, mask, *static)),
                    ("bwd", e_bwd, lambda: bwd(*bargs, *static),
                     lambda: bwd_plain(*bargs, *static))):
                key = f"{fam}_{d}_{kind}"
                errs[key] = e
                ms[key] = (cuda_ms(fn), cuda_ms(plain, reps=3, iters=1))
                costs[key] = cost(kind, b * n * heads, keys, pairs, b * n,
                                  2, width=d)
                library[key] = sdpa[0 if kind == "fwd" else 1]
            del qkv, cot, want, bargs, q, k, v
            torch.cuda.empty_cache()
        # K7 at (b*h 512, n 256, d), causal with key pads
        bh, n, h = 512, 256, 8
        lengths = [n // 2 + (37 * i) % (n // 2 + 1) for i in range(bh // h)]
        per_row = [L for L in lengths for _ in range(h)]
        mask_bh = key_mask(per_row, n)
        q, k, v, do = (rand(tgen, bh, n, d, scale=d ** -0.25 if i < 2
                            else 1.0, dtype=BF16) for i in range(4))
        label = f"K7 bf16 (b*h {bh}, n {n}, {d}) causal key-pad"
        want = flash.flash_attention_fwd_plain(q, k, v, mask_bh, True)
        e_fwd = compare_elementwise(label, ("out", "lse"),
                                    flash.flash_attention_fwd(q, k, v,
                                                              mask_bh, True),
                                    want, BF16)
        bwd_args = (q, k, v, mask_bh, *want, do, True)
        got = flash.flash_attention_bwd(*bwd_args)
        if not all(map(torch.equal, got, flash.flash_attention_bwd(
                *bwd_args))):
            fail(f"{label}: two backward launches differ")
        e_bwd = compare_elementwise(label, ("dq", "dk", "dv"), got,
                                    flash.flash_attention_bwd_plain(
                                        *bwd_args), BF16)
        del got
        b4 = [t.reshape(bh // h, h, n, d) for t in (q, k, v, do)]
        sdpa = sdpa_ms(*b4[:3], key_mask(lengths, n), True, 1.0, b4[3])
        for kind, e, fn, plain in (
                ("fwd", e_fwd,
                 lambda: flash.flash_attention_fwd(q, k, v, mask_bh, True),
                 lambda: flash.flash_attention_fwd_plain(q, k, v, mask_bh,
                                                         True)),
                ("bwd", e_bwd, lambda: flash.flash_attention_bwd(*bwd_args),
                 lambda: flash.flash_attention_bwd_plain(*bwd_args))):
            key = f"k7_{d}_{kind}"
            errs[key] = e
            ms[key] = (cuda_ms(fn), cuda_ms(plain, reps=3, iters=1))
            costs[key] = flash_cost(kind, bh, n, per_row, True, width=d)
            library[key] = sdpa[0 if kind == "fwd" else 1]
        del q, k, v, do, want, bwd_args, b4
        torch.cuda.empty_cache()
    for key in sorted(ms):
        b_ms, b_by = bound(*costs[key])
        kms, sdpa = ms[key][0], library[key]
        print(f"  {key} bf16: kernel {kms:.4f} ms ({kms / sdpa:.2f}x sdpa),"
              f" plain {ms[key][1]:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"sdpa {sdpa:.4f} ms", flush=True)
    return errs, ms, costs, library


def flagship_wide_heads(CLIP, default_optimizer, make_train_step, counters):
    """Phase 21's full-width case: the flagship (dim 512, 6 + 6 layers, 256
    tokens) with its 512 head columns as 2 x 256 in both towers, bf16, on
    the megablock ('fused' in both towers) and the stored FF block, at b =
    256: served once (K-MEGA and K-FF every layer, finite latents) and one
    train step (K2 and K1 every layer, the loss within 0.5 of ln 256), no
    pad_heads call → a line."""
    b = 256
    gen = torch.Generator(device="cuda").manual_seed(213)
    text, images = texts(gen, b), rand(gen, b, 3, 256, 256, dtype=BF16)
    cfg = {**FLAGSHIP, "text_heads": 2, "text_dim_head": 256,
           "visual_heads": 2, "visual_dim_head": 256}
    model = CLIP(**cfg, **_FUSED, param_dtype=BF16, compute_dtype="bfloat16",
                 device="cuda", seed=213)
    depth = cfg["text_enc_depth"] + cfg["visual_enc_depth"]
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        latents = model(text, images, return_latents=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = {k: v for k, v in read_counts(counters).items() if v}
    if served != {"mega": depth, "kff": depth}:
        fail(f"flagship 2 x 256: serving launches {served}")
    if not all(t.shape == (b, 512) and torch.isfinite(t).all()
               for t in latents):
        fail("flagship 2 x 256: latents are not finite (b, 512)")
    step = make_train_step(model, default_optimizer(model.parameters(),
                                                    learning_rate=1e-4))
    step_ms, counts, peak, losses = timed_steps(
        lambda i: step(text, images, generator=torch.Generator(
            device="cuda").manual_seed(214)), 0, 1, counters)
    trained = {k: v for k, v in counts.items() if v}
    want = {k: depth for k in ("k2_fwd", "k2_bwd", "k1_fwd", "k1_p1",
                               "k1_p2")}
    if trained != want:
        fail(f"flagship 2 x 256: train-step launches {trained}, expected "
             f"{want}")
    check_losses("flagship 2 x 256", losses, b)
    del model, step
    torch.cuda.empty_cache()
    line = (f"flagship 2 x 256 (b {b}): served once in {serve_s * 1e3:.1f} "
            f"ms, one step {step_ms:.1f} ms ({b * 1e3 / step_ms:.1f} pairs/s,"
            f" the first, with its set-up), peak {peak:.2f} GiB, loss "
            f"{losses[0].item():.4f}, K2 and K1 {depth} a step")
    print(f"  {line}", flush=True)
    return line


def check_pads(label, widths, pads):
    """Fail unless phase 21's case `label` called `pad_heads` as
    PADDED_HEADS says: never where its heads run as they are; where they
    are padded, at their dim_head only, twice (w_qkv, w_out) for each
    megablock forward, none of which ran at the unpadded width → words
    for the case's line."""
    if label not in PADDED_HEADS:
        if pads:
            fail(f"{label}: pad_heads ran at dim_head {sorted(set(pads))}, "
                 "a width its kernels take as it is")
        return "no pad_heads call"
    d, width = PADDED_HEADS[label]
    forwards = widths[("mega", "fwd", width)]
    if (set(pads) != {d} or len(pads) != 2 * forwards
            or any(w == d for *_, w in widths)):
        fail(f"{label}: pad_heads ran {len(pads)} times at dim_head "
             f"{sorted(set(pads))} for {forwards} megablock forwards at "
             f"{width}, launches by width {dict(widths)}")
    return (f"pad_heads {len(pads)} times, {d} to {width}, 2 a megablock "
            "forward")


def narrow_heads(card, CLIP, default_optimizer, make_train_step, counters):
    """Phase 21: heads of 32, 80, 128, 192 and 256 (NARROW_HEADS) served
    and trained on the card through the entry points, every layer on its
    kernel, no fallback warning and no `pad_heads` call where the case's
    heads are a width its kernels take as they are (the one case that
    pads, 2 heads of 80 to 96, calls it as `check_pads` says); latents and
    the first
    loss against the plain routes' on the same weights and inputs (phase
    4's and phase 11's tolerances); the wrappers alone at dim_head 32; the
    128-wide kernels alone (`wide_kernels`), the 192- and 256-wide ones
    (`true_width_kernels`) and the flagship with 2 x 256 heads
    (`flagship_wide_heads`); and the shapes past the CUDA kernels
    (PAST_KERNELS) raising at the entry point. Returns (wide_kernels'
    results, {case: launches of each counter and the megablock core's over
    its serving and train step}, true_width_kernels' results, {case:
    launches by (family, kind, head width)})."""
    from xclip_tpu_torch.kernels import attention_megablock as mega
    bf16 = torch.bfloat16
    lines = narrow_wrappers()
    wide = wide_kernels()
    true_width = true_width_kernels()
    cores = {"core_fwd": mega.mega_core_fwd, "core_bwd": mega.mega_core_bwd}
    every = {**counters, **cores}
    lines.append(flagship_wide_heads(CLIP, default_optimizer,
                                     make_train_step, counters))
    case_launches, case_widths = {}, {}
    widths, pads = collections.Counter(), []
    for label, extra, routes, want_serve, want_train, dt in NARROW_HEADS:
        widths.clear()
        pads.clear()
        tol = LATENT_TOL[dt]
        gen = torch.Generator(device="cuda").manual_seed(21)
        text = texts(gen, 4, seq=32, vocab=1000)
        images = rand(gen, 4, 3, 64, 64, dtype=dt)
        cfg = {**HEADS_BASE, **extra}
        compute = "bfloat16" if dt == bf16 else None
        model = CLIP(**cfg, **routes, param_dtype=dt, compute_dtype=compute,
                     device="cuda", seed=21)
        plain = CLIP(**cfg, **PLAIN_ROUTES, param_dtype=dt,
                     compute_dtype=compute, device="cuda")
        plain.load_state_dict(model.state_dict())
        zero_counts(every)
        with contextlib.ExitStack() as spies:
            for spy in width_spies(widths, pads):
                spies.enter_context(spy)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with torch.no_grad():
                    latents = model(text, images, return_latents=True)
            torch.cuda.synchronize()
            serve_counts = read_counts(every)
        served = {k: v for k, v in serve_counts.items()
                  if v and k not in cores}
        fallbacks = [str(w.message) for w in caught
                     if "falling back to the XLA path" in str(w.message)]
        if fallbacks:
            fail(f"{label}: fallback warnings {fallbacks}")
        if served != want_serve:
            fail(f"{label}: serving launches {served}, expected {want_serve}")
        with torch.no_grad():
            worst = max((a - b).abs().max().item() for a, b in zip(
                latents, plain(text, images, return_latents=True)))
        if not (worst <= tol and all(torch.isfinite(t).all()
                                     for t in latents)):
            fail(f"{label}: latents differ from the plain routes' by "
                 f"{worst:.3e} > {tol:.0e}")
        losses = []
        for m in (model, plain):
            step = make_train_step(m, default_optimizer(m.parameters(),
                                                        learning_rate=1e-4))
            zero_counts(every)
            with contextlib.ExitStack() as spies:
                if m is model:
                    for spy in width_spies(widths, pads):
                        spies.enter_context(spy)
                # the same patch-dropout draw on both routes
                losses.append(step(text, images, generator=torch.Generator(
                    device="cuda").manual_seed(22))["loss"].float().item())
                torch.cuda.synchronize()
            if m is model:
                train_counts = read_counts(every)
                trained = {k: v for k, v in train_counts.items()
                           if v and k not in cores}
        case_launches[label] = {k: serve_counts[k] + train_counts[k]
                                for k in every}
        case_widths[label] = dict(widths)
        padded = check_pads(label, widths, pads)
        if trained != want_train:
            fail(f"{label}: train-step launches {trained}, expected "
                 f"{want_train}")
        diff = abs(losses[0] - losses[1])
        if not (math.isfinite(losses[0]) and diff <= 0.05):
            fail(f"{label}: first loss {losses[0]:.4f} against the plain "
                 f"routes' {losses[1]:.4f}")
        lines.append(f"{label}: latents {worst:.2e}, loss {losses[0]:.4f} "
                     f"(plain {losses[1]:.4f})")
        print(f"  {label}: serving launches {served}, train-step launches "
              f"{trained} (megablock core "
              f"{case_launches[label]['core_fwd']} / "
              f"{case_launches[label]['core_bwd']}; by width "
              f"{ {k: v for k, v in sorted(widths.items())} }); {padded}; "
              f"latents vs plain routes {worst:.3e} (tol {tol:.0e}); "
              f"first loss {losses[0]:.4f}, plain routes {losses[1]:.4f} "
              "(tol 0.05)", flush=True)
        del model, plain, step
        torch.cuda.empty_cache()
    for label, extra, routes, words, dt in PAST_KERNELS:
        gen = torch.Generator(device="cuda").manual_seed(21)
        model = CLIP(**{**HEADS_BASE, **extra}, **routes, param_dtype=dt,
                     compute_dtype="bfloat16" if dt == bf16 else None,
                     device="cuda", seed=21)
        try:
            with torch.no_grad():
                model(texts(gen, 4, seq=32, vocab=1000),
                      rand(gen, 4, 3, 64, 64, dtype=dt),
                      return_latents=True)
        except ValueError as e:
            if words not in str(e):
                fail(f"{label}: raised {e!r}, expected the limit {words!r}")
            print(f"  {label}: raises {e}", flush=True)
            lines.append(f"{label}: raises")
        else:
            fail(f"{label}: served past the CUDA kernels' limit")
        del model
    for key, case, *_ in TRUE_WIDTH_KERNELS:
        fam, d, kind = key.split("_")
        if not case_widths[case].get((fam, kind, int(d))):
            fail(f"{case}: no {fam} {kind} launch at heads of {d}")
    phase(21, "heads", f"{card}: bf16 heads of 32, 80, 192 and 256 at their "
          "true width and 128 in both dtypes on the kernels, no pad_heads "
          "call but 2 x 80's to 96; the 128-, 192- and 256-wide kernels "
          "against their plain "
          "versions; shapes past them raise: " + "; ".join(lines))
    return wide, case_launches, true_width, case_widths


# phase 22: remat configurations (label, checkpoint_during_training,
# remat_policy), the first without remat
REMAT_CONFIGS = (("no remat", False, None), ("None", True, None),
                 ("dots", True, "dots"), ("wide", True, "wide"))
# JAX's words when attention and FF dropout take the kernels off
DROPOUT_WARNINGS = {
    "attn_impl='fused' requested but falling back to the XLA path: "
    "attn_dropout > 0 in training mode (the fused whole-head kernel has no "
    "attention dropout)",
    "ff_impl='block_stored' requested but falling back to the XLA path: "
    "ff_dropout active in training mode"}
VALID_REFUSAL = ("row_valid requires the plain InfoNCE loss "
                 "(loss_impl='xla', no FILIP, no sim_reg)")


def step_gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def grads_of(model, text, images, **kw):
    """One training forward and backward: (loss, {name: gradient})."""
    model.zero_grad(set_to_none=True)
    loss = model(text, images, return_loss=True, **kw)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}


def differing(a, b):
    """What of two (loss, gradients) results is not bit for bit equal."""
    (la, ga), (lb, gb) = a, b
    bad = [] if torch.equal(la, lb) else ["loss"]
    if ga.keys() != gb.keys():
        return bad + ["the set of gradients"]
    return bad + [k for k in ga if not torch.equal(ga[k], gb[k])]


def same_params(a, b):
    """Names of the parameters of two models that differ."""
    return [n for (n, p), q in zip(a.named_parameters(), b.parameters())
            if not torch.equal(p.detach().cpu(), q.detach().cpu())]


def train_surface(card, CLIP, default_optimizer, make_train_step, ffb, mega,
                  lse5, lean2048):
    """Phase 22: the training surface on the flagship at b = 256 from phase
    8's weights and inputs (stored route, bf16): remat under None, 'dots'
    and 'wide' bit for bit the step without remat, with the kernels'
    forward launches it computes and 'dots''s saved products per layer;
    the stored route at b = 2048 under remat beside phase 11's lean step
    (`lean2048`: ms, peak GiB); grad_accum=2 bit for bit the mean of two
    128-row backwards; valid= against the truncated batch; checkpoint and
    resume bit for bit; custom encoders with dropout: JAX's warnings, K5
    and no block kernel, the kept share, remat + dropout bit for bit."""
    import tempfile
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    from xclip_tpu_torch.nn import layers
    from xclip_tpu_torch.nn.core import RngStream
    from xclip_tpu_torch.nn.text import TextTransformer
    from xclip_tpu_torch.nn.vision import VisionTransformer
    from xclip_tpu_torch.train import restore_checkpoint, save_checkpoint
    bf16 = torch.bfloat16
    b, warm, timed, depth = 256, 2, 5, 6
    gen = torch.Generator(device="cuda").manual_seed(8)
    text, images = texts(gen, b), rand(gen, b, 3, 256, 256, dtype=bf16)
    keep = torch.rand((b, 64), generator=gen, device="cuda").topk(
        32, dim=-1).indices
    on_card = dict(param_dtype=bf16, compute_dtype="bfloat16", device="cuda")
    init = {k: v.clone() for k, v in CLIP(**FLAGSHIP, **KERNEL_ROUTES,
                                          **on_card, seed=0)
            .state_dict().items()}

    def model(routes=KERNEL_ROUTES, **flags):
        m = CLIP(**FLAGSHIP, **routes, **on_card, **flags)
        m.load_state_dict(init)
        return m

    def timed_run(m, label, batch, steps, counters, want, accum=1):
        """Warm-up and timed steps of `m` (AdamW lr 1e-4): every counter
        `want` a step; → (ms, peak GiB); prints pairs/s, and the idle share
        and device time of one profiled step after them."""
        t, im = batch
        step = make_train_step(m, default_optimizer(m.parameters(),
                                                    learning_rate=1e-4),
                               grad_accum=accum)

        def run(i):
            return step(t, im, generator=step_gen(100 + i))

        ms, counts, peak, losses = timed_steps(run, *steps, counters)
        per_step = {k: v / sum(steps) for k, v in counts.items()}
        if per_step != want:
            fail(f"{label}: launches per step {per_step}, expected {want}")
        check_losses(label, losses, t.shape[0] // accum)   # a microbatch's
        (idle, busy, window), _ = profile_step(run, sum(steps))
        print(f"  {label}: {t.shape[0] * 1e3 / ms:.1f} pairs/s ({ms:.2f} ms "
              f"per step), peak memory {peak:.2f} GiB, idle share "
              f"{idle:.4f} (device busy {busy:.2f} of {window:.2f} ms), "
              "losses " + " ".join(f"{v:.4f}" for v in losses.tolist()),
              flush=True)
        return ms, peak

    stored = {"k2_fwd": mega.attention_block_fwd_stored,
              "k2_bwd": mega.attention_block_bwd,
              "k1_fwd": ffb.ff_block_fwd_stored, "k1_p1": ffb.ff_block_bwd_p1,
              "k1_p2": ffb.ff_block_bwd_p2}

    def stored_launches(passes):
        """The stored route's launches over one forward and backward: K2 in
        the text tower's layers, K1 in both towers'; each forward kernel
        `passes` times (2 where a recompute runs it again)."""
        return {"k2_fwd": depth * passes, "k2_bwd": depth,
                "k1_fwd": 2 * depth * passes, "k1_p1": 2 * depth,
                "k1_p2": 2 * depth}

    # (a) remat on the stored route, b = 256
    regions = []

    def counting_context():
        """'dots''s contexts, counting the products each layer keeps."""
        regions.append(0)

        def policy(ctx, op, *args, **kwargs):
            kept = layers.save_products(ctx, op, *args, **kwargs)
            if kept == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                regions[-1] += 1
            return kept
        return create_selective_checkpoint_contexts(policy)

    remat = {}
    for label, ckpt, policy in REMAT_CONFIGS:
        m = model(checkpoint_during_training=ckpt, remat_policy=policy)
        passes = 2 if ckpt and policy != "wide" else 1
        want = stored_launches(passes)
        zero_counts(stored)
        regions.clear()
        with mock.patch.object(layers, "_dots_context", counting_context):
            result = grads_of(m, text, images, generator=step_gen(100))
        torch.cuda.synchronize()
        if read_counts(stored) != want:
            fail(f"remat {label}: launches {read_counts(stored)} over one "
                 f"forward and backward, expected {want}")
        if policy == "dots" and regions != [0] * depth + [2] * depth:
            fail(f"remat 'dots': products kept per layer {regions}, "
                 f"expected none in a text layer, 2 in a vision layer")
        if label == "no remat":
            ref = result
            bad = differing(ref, grads_of(m, text, images,
                                          generator=step_gen(100)))
            if bad:
                fail(f"two launches of the same step differ in {bad}")
        else:
            bad = differing(ref, result)
            if bad:
                fail(f"remat {label}: loss and gradients are not bit for "
                     f"bit the step's without remat: {bad}")
        remat[label] = timed_run(m, f"stored b={b} remat {label}",
                                 (text, images), (warm, timed), stored,
                                 stored_launches(passes))
        del m, result
        torch.cuda.empty_cache()
    lines = ["remat None / 'dots' / 'wide' bit for bit the step without, "
             "K2 and K1 forwards 2 / 2 / 1 a layer, 'dots' keeping 0 "
             "products a text layer and 2 a vision layer; pairs/s "
             + " / ".join(f"{label} {b * 1e3 / ms:.1f} ({peak:.2f} GiB)"
                          for label, (ms, peak) in remat.items())]

    # (b) the stored route at b = 2048 under remat (without it, it would
    # not fit), beside phase 11's memory-lean step on the same inputs
    gen = torch.Generator(device="cuda").manual_seed(11)
    big = texts(gen, 2048), rand(gen, 2048, 3, 256, 256, dtype=bf16)
    ms, peak = timed_run(model(checkpoint_during_training=True),
                         "stored b=2048 remat None", big, (2, 3), stored,
                         stored_launches(2))
    del big
    torch.cuda.empty_cache()
    print(f"  lean routes b=2048 (phase 11): {2048e3 / lean2048[0]:.1f} "
          f"pairs/s ({lean2048[0]:.2f} ms), peak {lean2048[1]:.2f} GiB",
          flush=True)
    lines.append(f"b=2048 stored + remat None {2048e3 / ms:.1f} pairs/s "
                 f"({peak:.2f} GiB; lean {2048e3 / lean2048[0]:.1f}, "
                 f"{lean2048[1]:.2f} GiB)")

    # (c) grad_accum=2: the mean of two 128-row backwards, bit for bit, and
    # the optimizer's update of it
    m, twin = model(), model()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        opt = default_optimizer(m.parameters(), learning_rate=1e-4)
        step = make_train_step(m, opt, grad_accum=2)
    if not any("grad_accum=2" in str(w.message) for w in caught):
        fail("grad_accum=2 gave no warning")
    metrics = step(text, images, keep_idx=keep)
    halves = [grads_of(twin, text[r], images[r], keep_idx=keep[r])
              for r in (slice(0, b // 2), slice(b // 2, b))]
    mean = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in halves[0][1]}
    got = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    bad = differing((metrics["loss"], got),
                    ((halves[0][0] + halves[1][0]) / 2, mean))
    if bad:
        fail(f"grad_accum=2: not bit for bit the mean of two 128-row calls: "
             f"{bad}")
    twin_opt = default_optimizer(twin.parameters(), learning_rate=1e-4)
    for n, p in twin.named_parameters():
        p.grad = mean.get(n)
    twin_opt.step()
    bad = same_params(m, twin)
    if bad:
        fail(f"grad_accum=2: the update is not the optimizer's on the mean "
             f"gradient: {bad[:5]}")
    del twin, twin_opt, halves, mean, got
    accum = timed_run(m, f"stored b={b} grad_accum=2", (text, images),
                      (2, 3), stored,
                      {k: 2 * v for k, v in stored_launches(1).items()},
                      accum=2)
    lines.append(f"grad_accum=2 bit for bit (g1 + g2) / 2 and its update, "
                 f"{b * 1e3 / accum[0]:.1f} pairs/s ({accum[1]:.2f} GiB)")
    del m, step, opt
    torch.cuda.empty_cache()

    # (d) valid=: the last 56 rows padding, against the truncated batch.
    # bf16 gradients are held to bf16's unit roundoff, 2^-8: the two
    # batches' cotangents differ by fp32 rounding (the LSE sums 256 columns
    # or 200), which the bf16 backward rounds to other neighbours in some
    # elements, summed over the batch in the shared weights; fp32 on the
    # same weights holds the masking itself to 1e-3
    valid = torch.arange(b, device="cuda") < 200
    held = []
    for dtype, tol in ((bf16, 2.0 ** -8), (torch.float32, 1e-3)):
        m = (model() if dtype == bf16 else
             CLIP(**FLAGSHIP, **KERNEL_ROUTES, device="cuda"))
        m.load_state_dict(init)
        im = images.to(dtype)
        padded = grads_of(m, text, im, keep_idx=keep, row_valid=valid)
        short = grads_of(m, text[:200], im[:200], keep_idx=keep[:200])
        loss_rel = (abs(padded[0].item() - short[0].item())
                    / abs(short[0].item()))
        frob = {k: ((padded[1][k].float() - g.float()).norm()
                    / g.float().norm().clamp(min=1e-30)).item()
                for k, g in short[1].items()}
        worst = sorted(frob, key=frob.get, reverse=True)
        tag = str(dtype).split(".")[-1]
        print(f"  valid= {tag} (56 of {b} rows padding): loss "
              f"{padded[0].item():.6f} vs the 200-row batch's "
              f"{short[0].item():.6f}, relative {loss_rel:.2e} (tol 1e-5); "
              f"gradients' relative Frobenius error: "
              + ", ".join(f"{k} {frob[k]:.2e}" for k in worst[:3])
              + f"; {sum(v > 1e-3 for v in frob.values())} of {len(frob)} "
              f"above 1e-3 (tol {tol:.2e})", flush=True)
        if not loss_rel <= 1e-5 or not frob[worst[0]] <= tol:
            fail(f"valid= {tag}: loss {loss_rel:.2e} relative (tol 1e-5), "
                 f"gradient {worst[0]} {frob[worst[0]]:.2e} relative "
                 f"Frobenius (tol {tol:.2e})")
        held.append(f"{tag} loss {loss_rel:.1e}, gradients "
                    f"{frob[worst[0]]:.1e}")
        del m, padded, short
        torch.cuda.empty_cache()
    fused = model({**KERNEL_ROUTES, "loss_impl": "fused"})
    try:
        fused(text, images, return_loss=True, keep_idx=keep, row_valid=valid)
        fail("valid= under loss_impl='fused' did not raise")
    except AssertionError as e:
        if str(e) != VALID_REFUSAL:
            fail(f"valid= under loss_impl='fused' raised {e!r}")
    del fused
    torch.cuda.empty_cache()
    lines.append("valid= against the truncated batch: " + ", ".join(held)
                 + "; refused under K5")

    # (e) checkpoint and resume: save after two steps; a fresh model and
    # optimizer loaded from it take the third step bit for bit
    m = model()
    opt = default_optimizer(m.parameters(), learning_rate=1e-4)
    step = make_train_step(m, opt)
    for i in range(2):
        step(text, images, generator=step_gen(100 + i))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "step_2")
        save_checkpoint(path, m, opt, step=2)
        saved = CLIP(**FLAGSHIP, **KERNEL_ROUTES, **on_card, seed=2)
        saved.load_state_dict(m.state_dict())
        want = step(text, images, generator=step_gen(102))
        fresh = CLIP(**FLAGSHIP, **KERNEL_ROUTES, **on_card, seed=1)
        fresh_opt = default_optimizer(fresh.parameters(), learning_rate=1e-4)
        if restore_checkpoint(path, fresh, fresh_opt) != 2:
            fail("checkpoint: the saved step is not 2")
        host = CLIP(**FLAGSHIP, **KERNEL_ROUTES,
                    **{**on_card, "device": "cpu"}, seed=1)
        restore_checkpoint(path, host)
        bad = same_params(saved, fresh) + same_params(saved, host)
        if bad:
            fail(f"checkpoint: parameters loaded on the card or the CPU "
                 f"differ from the saved ones: {bad[:5]}")
        del saved, host
        got = make_train_step(fresh, fresh_opt)(text, images,
                                                generator=step_gen(102))
    bad = same_params(m, fresh)
    bad += [k for k in want if not torch.equal(want[k], got[k])]
    a, c = opt.state_dict(), fresh_opt.state_dict()
    bad += ["count"] if a["count"] != c["count"] else []
    bad += [f"{i} {mom}" for i in a["state"] for mom in ("mu", "nu")
            if not torch.equal(a["state"][i][mom], c["state"][i][mom])]
    if bad:
        fail(f"checkpoint: the resumed third step differs in {bad[:8]}")
    lines.append("resume bit for bit (parameters, moments, count 3, "
                 "metrics); loads on the CPU")
    del m, opt, step, fresh, fresh_opt
    torch.cuda.empty_cache()

    # (f) custom encoders with attention and FF dropout 0.1 on the kernel
    # flags: JAX's warnings, K5 and no block kernel, the kept share, and
    # remat + dropout bit for bit dropout alone
    def dropout_model(**flags):
        g = torch.Generator().manual_seed(0)
        tower = dict(depth=depth, heads=8, ff_impl="block_stored",
                     attn_dropout=0.1, ff_dropout=0.1, generator=g,
                     dtype=bf16, **flags)
        m = CLIP(**FLAGSHIP, attn_impl="fused", loss_impl="fused", **on_card,
                 text_encoder=TextTransformer(512, 10000, 256, **tower),
                 image_encoder=VisionTransformer(512, 256, 32, **tower))
        m.load_state_dict(init)
        return m

    blocks = {"mega": mega.attention_block, "kff": ffb.ff_block, **stored,
              "k3_fwd": mega.attention_block_fwd_stats,
              "k3_bwd": mega.attention_block_bwd_recompute,
              "kffs": ffb.ff_block_fwd_stats,
              "ff_rc": ffb.ff_block_bwd_recompute,
              "k5_fwd": lse5.streaming_lse_fwd,
              "k5_bwd": lse5.streaming_lse_bwd}
    want = {k: 2 if k.startswith("k5") else 0 for k in blocks}
    sites = []
    draw = RngStream.keep

    def recording(self, shape, rate, device):
        mask = draw(self, shape, rate, device)
        sites.append((mask.sum(), mask.numel(), rate))
        return mask

    m = dropout_model()
    zero_counts(blocks)
    with warnings.catch_warnings(record=True) as caught, \
            mock.patch.object(RngStream, "keep", recording):
        warnings.simplefilter("always")
        ref = grads_of(m, text, images, generator=step_gen(100))
    torch.cuda.synchronize()
    said = [str(w.message) for w in caught if "falling back" in str(w.message)]
    if sorted(said) != sorted(DROPOUT_WARNINGS):
        fail(f"dropout: fallback warnings {said}, expected JAX's "
             f"{sorted(DROPOUT_WARNINGS)} once each")
    if read_counts(blocks) != want:
        fail(f"dropout: launches {read_counts(blocks)}, expected {want}")
    if len(sites) != 4 * depth:
        fail(f"dropout: {len(sites)} sites drew, expected {4 * depth}")
    shares = []
    for kept, n, rate in sites:
        kept = kept.item()
        shares.append(kept / n)
        if not abs(kept - n * (1 - rate)) <= 4 * math.sqrt(
                n * rate * (1 - rate)):
            fail(f"dropout: a site kept {kept} of {n}, not 1 - {rate} "
                 f"within 4 sigma")
    drop = timed_run(m, f"dropout b={b}", (text, images), (warm, timed),
                     blocks, want)
    del m
    torch.cuda.empty_cache()
    m = dropout_model(checkpoint_during_training=True)
    bad = differing(ref, grads_of(m, text, images, generator=step_gen(100)))
    if bad:
        fail(f"dropout: remat None is not bit for bit dropout alone: {bad}")
    del m, ref
    torch.cuda.empty_cache()
    lines.append(f"dropout: JAX's 2 warnings, K5 and no block kernel, kept "
                 f"shares {min(shares):.5f}-{max(shares):.5f} of 24 sites, "
                 f"remat + dropout bit for bit, {b * 1e3 / drop[0]:.1f} "
                 f"pairs/s ({drop[1]:.2f} GiB)")
    phase(22, "train-surface", f"{card}: " + "; ".join(lines))


# ------------------------------------------------------------------- 23
GOLDEN_OBJECTIVES = GOLDEN.with_name("torch_port_golden_objectives.npz")
# the fp32 kernels of phase 23's step by the names the profiler gives
# them: the product kernel, and the FMA attention core's forward, dq and
# dk/dv (csrc/attention_core.cuh, fp32 only)
FP32_STEP_KERNELS = {"products": ("gemm_f32_kernel",),
                     "attention core forward": ("attention_fwd_kernel",),
                     "attention core dq": ("attention_bwd_dq_kernel",),
                     "attention core dk/dv": ("attention_bwd_dkv_kernel",)}
# the reference README's full configuration: every objective that combines
OBJECTIVE_FLAGS = dict(use_mlm=True, use_visual_ssl=True,
                       decoupled_contrastive_learning=True,
                       extra_latent_projection=True, sim_reg_loss_weight=0.1,
                       loss_impl="fused")
# the kernel routes in both towers: stored (K2, K1) and memory-lean (K3,
# K-FF-s with the recompute backward); the plain routes everywhere
STORED_BOTH = dict(attn_impl="fused", visual_attn_impl=None,
                   ff_impl="block_stored")
LEAN_BOTH = dict(attn_impl="fused_recompute", visual_attn_impl=None,
                 ff_impl="block")
PLAIN_BOTH = dict(attn_impl="xla", visual_attn_impl=None, ff_impl="xla")
METRIC_KEYS = ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
               "multiview_cl_loss", "sim_reg_loss", "temperature")


def objective_draws(model, gen, text, views=2, ssl_passes=4):
    """Every draw of one training forward of `model` (a `CLIP`) on `text`
    and its images, from `gen`: the main vision pass's patch indices over
    `views` image views, the MLM's and the visual SSL's draws."""
    from xclip_tpu_torch.objectives.augment import augment_draws
    core = model.model
    b, patches = text.shape[0], core.visual.num_patches
    kept = max(1, int(patches * (1 - core.visual.patch_dropout)))

    def keep(rows):
        return torch.rand(rows, patches, generator=gen,
                          device="cuda").topk(kept, dim=-1).indices

    d = {"keep_idx": keep(b * views)}
    if core.mlm is not None:
        d["mlm_draws"] = core.mlm.draws(text, gen)
    if core.visual_ssl is not None:
        d["ssl_draws"] = {"augment": [augment_draws(gen) for _ in range(2)],
                          "keep_idx": [keep(b) for _ in range(ssl_passes)]}
    return d


def bf16_tol(v):
    """0.05, or two bf16 ulps at |v| where that is more (a loss returned
    in bf16, as the MLM's is)."""
    return max(0.05, 2 * 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30)))
                                 - 7))


def check_objective_metrics(label, m, b):
    """The first step's metrics at init: all finite; the CL and multiview
    losses within 0.5 of ln(b − 1) (DCL drops the positive), the MLM loss
    within 1.5 of ln 10000, SimSiam's 2 − 2cos pair sum in [0, 8], sim-reg
    in [0, 4]."""
    v = {k: m[k].float().item() for k in METRIC_KEYS}
    if not all(math.isfinite(x) for x in v.values()):
        fail(f"{label}: a metric is not finite: {v}")
    ln = math.log(b - 1)
    checks = {"cl_loss": abs(v["cl_loss"] - ln) <= 0.5,
              "multiview_cl_loss": abs(v["multiview_cl_loss"] - ln) <= 0.5,
              "text_ssl_loss": abs(v["text_ssl_loss"] - math.log(1e4)) <= 1.5,
              "image_ssl_loss": 0.0 <= v["image_ssl_loss"] <= 8.0,
              "sim_reg_loss": 0.0 <= v["sim_reg_loss"] <= 4.0}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"{label}: {bad} out of range: {v}")
    return v


def bn_buffers(model):
    return {n: t.clone() for n, t in model.state_dict().items()
            if n.endswith((".mean", ".var"))}


def objectives_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
                      make_train_step, counters):
    """The tiny CLIP with every objective that combines, fp32, on the
    kernel routes in both towers, one step against the JAX golden: the
    loss and each metric 1e-5, every gradient 1e-3 of the leaf's largest
    magnitude + 1e-5, the parameters after the step 1e-5 (phase 7's rule),
    the BatchNorm statistics 1e-6 + 1e-5 relative. → a summary line."""
    from xclip_tpu_torch.convert import to_jax_tree
    from xclip_tpu_torch.objectives.ssl import SimSiam
    g = np.load(GOLDEN_OBJECTIVES)
    config = json.loads(str(g["config"]))
    ssl = SimSiam(**json.loads(str(g["ssl"])))
    tiny = CLIP(**config, visual_ssl=ssl, device="cuda")
    load_jax_params(tiny, numpy_params({**config, "visual_ssl": ssl},
                                       int(g["seed"])))

    def dev(k):
        return torch.from_numpy(g[k]).cuda()

    draws = dict(keep_idx=dev("keep_idx"),
                 mlm_draws={k[4:]: dev(k) for k in g.files
                            if k.startswith("mlm/")},
                 ssl_draws={"augment": json.loads(str(g["ssl_augment"])),
                            "keep_idx": [dev(f"ssl_keep_idx/{i}")
                                         for i in range(4)]})
    step = make_train_step(tiny, default_optimizer(
        tiny.parameters(), **json.loads(str(g["train_optimizer"]))))
    zero_counts(counters)
    metrics = step(dev("text"), dev("images"), aug_text=dev("aug_text"),
                   aug_image=dev("aug_images"), **draws)
    torch.cuda.synchronize()
    idle = [k for k, v in read_counts(counters).items() if not v]
    if idle:
        fail(f"objectives golden: {idle} never launched")
    metric_err = max(abs(metrics[k].item() - float(g[f"metric/{k}"]))
                     for k in METRIC_KEYS)
    norm_err = abs(metrics["grad_norm"].item() - float(g["train_grad_norm"]))
    if not (metric_err <= 1e-5 and norm_err <= 1e-4):
        fail(f"objectives golden: metric err {metric_err:.3e}, grad norm "
             f"err {norm_err:.3e}")
    grad_worst = param_worst = bn_worst = 0.0
    for name, got in _flat(to_jax_tree(tiny, grads=True)):
        want = g[f"grad/{name}"]
        err = float(np.abs(got - want).max())
        if not err <= 1e-3 * float(np.abs(want).max()) + 1e-5:
            fail(f"objectives golden: gradient {name} differs by {err:.3e}")
        grad_worst = max(grad_worst, err)
    for name, got in _flat(to_jax_tree(tiny)):
        want = g[f"param1/{name}"]
        err = float(np.abs(got - want).max())
        if name.endswith(("/mean", "/var")):
            if not err <= 1e-6 + 1e-5 * float(np.abs(want).max()):
                fail(f"objectives golden: statistic {name} differs by "
                     f"{err:.3e}")
            bn_worst = max(bn_worst, err)
        elif not err <= 1e-5:
            fail(f"objectives golden: parameter {name} differs by {err:.3e}")
        else:
            param_worst = max(param_worst, err)
    return (f"golden (fp32, kernel routes, MLM + SimSiam + multiview + "
            f"sim-reg + DCL + extra + K5) metrics err {metric_err:.3e} (tol "
            f"1e-5), max grad err {grad_worst:.3e}, params after the step "
            f"{param_worst:.3e} (tol 1e-5), BN statistics {bn_worst:.3e}")


def objectives(card, CLIP, default_optimizer, make_train_step, ffb, mega,
               lse5, load_jax_params, numpy_params, b=256, warm=2, timed=5):
    """Phase 23: every objective on the flagship, bf16, b = 256 (see the
    module docstring)."""
    from xclip_tpu_torch.kernels import matmul
    from xclip_tpu_torch.objectives.augment import default_augment
    from xclip_tpu_torch.objectives.ssl import get_representation
    few = min(64, b)
    gen = step_gen(23)
    text, aug_text = texts(gen, b), texts(gen, b)
    images = rand(gen, b, 3, 256, 256, dtype=torch.bfloat16)
    # the batch's own dtype, as a user passes it (an fp32 view would
    # promote the batch, as jnp.concatenate does)
    aug_images = default_augment(images, 256, generator=gen).bfloat16()
    views = dict(aug_text=aug_text, aug_image=aug_images)
    lines = []

    def build(routes, **flags):
        return CLIP(**{**FLAGSHIP, **flags}, **routes,
                    param_dtype=torch.bfloat16, compute_dtype="bfloat16",
                    device="cuda", seed=0)

    def one_step(m, draws, **kw):
        step = make_train_step(m, default_optimizer(m.parameters(),
                                                    learning_rate=1e-4))
        return step(text, images, **kw, **draws)

    blocks = {"mega": mega.attention_block, "kff": ffb.ff_block,
              "k5_fwd": lse5.streaming_lse_fwd,
              "k5_bwd": lse5.streaming_lse_bwd}
    stored = {"k2_fwd": mega.attention_block_fwd_stored,
              "k2_bwd": mega.attention_block_bwd,
              "k1_fwd": ffb.ff_block_fwd_stored, "k1_p1": ffb.ff_block_bwd_p1,
              "k1_p2": ffb.ff_block_bwd_p2, **blocks}
    lean = {"k3_fwd": mega.attention_block_fwd_stats,
            "k3_bwd": mega.attention_block_bwd_recompute,
            "kffs": ffb.ff_block_fwd_stats,
            "ff_rc": ffb.ff_block_bwd_recompute, **blocks}
    # a step's tower calls, 6 layers each: with gradients the MLM pass and
    # the main text pass (text), SimSiam's two online passes and the main
    # pass over both image views (vision); without, its two target passes
    # (the inference forwards K-MEGA, K-FF); K5 over 2 x 2 view pairs, two
    # directions each
    depth, grad_calls, target_calls = 6, 5, 2
    per_block = {"mega": depth * target_calls, "kff": depth * target_calls,
                 "k5_fwd": 8, "k5_bwd": 8}
    want_stored = {**{k: depth * grad_calls for k in stored
                      if k not in blocks}, **per_block}
    want_lean = {**{k: depth * grad_calls for k in lean if k not in blocks},
                 **per_block}

    # (a) the full objective on the stored routes, then the plain routes
    kernel = build(STORED_BOTH, **OBJECTIVE_FLAGS)
    init = {k: v.clone() for k, v in kernel.state_dict().items()}
    draws0 = objective_draws(kernel, step_gen(7), text)
    first = one_step(kernel, draws0, **views)
    torch.cuda.synchronize()
    v = check_objective_metrics("stored routes", first, b)
    moved = [k for k, t in bn_buffers(kernel).items()
             if torch.equal(t, init[k])]
    if moved:
        fail(f"BatchNorm statistics not folded: {moved}")
    # under remat (bit for bit without it, phase 22): 768 caption rows of
    # the plain attention's saved scores would not fit in 80 GB
    plain = build(PLAIN_BOTH, **OBJECTIVE_FLAGS,
                  checkpoint_during_training=True)
    plain.load_state_dict(init)
    p = {k: x.float().item() for k, x in one_step(plain, draws0,
                                                  **views).items()}
    del plain
    torch.cuda.empty_cache()
    diffs = {k: abs(v[k] - p[k]) for k in METRIC_KEYS}
    bad = [k for k, d in diffs.items() if not d <= bf16_tol(p[k])]
    if bad:
        fail(f"stored vs plain routes, same weights and draws: {bad} "
             f"differ: {v} vs {p}")
    lines.append("first step " + ", ".join(
        f"{k} {v[k]:.4f}" for k in METRIC_KEYS[1:6])
        + f" (ln 255 = {math.log(255):.4f}, ln 10000 = {math.log(1e4):.4f});"
        f" vs plain routes max diff {max(diffs.values()):.3e} (tol 0.05 or "
        "2 bf16 ulps)")

    def timed_objective(m, label, counters, want, lean):
        m.load_state_dict(init)
        step = make_train_step(m, default_optimizer(m.parameters(),
                                                    learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=step_gen(100 + i), **views)

        matmul.kernel_launches(reset=True, dtype=torch.float32)
        ms, counts, peak, losses = timed_steps(run, warm, timed, counters)
        f32 = matmul.kernel_launches(dtype=torch.float32)
        per_step = {k: c / (warm + timed) for k, c in counts.items()}
        if per_step != want:
            fail(f"{label}: launches per step {per_step}, expected {want}")
        # the SimSiam passes' fp32 products, counted in the library
        want_f32 = expected_f32_products(ffb, mega, lean)
        if {k: c / (warm + timed) for k, c in f32.items()} != want_f32:
            fail(f"{label}: fp32 product kernel launches {f32} over "
                 f"{warm + timed} steps, expected {want_f32} a step")
        if not torch.isfinite(losses).all():
            fail(f"{label}: a loss is not finite: {losses.tolist()}")
        (idle, busy, window), (total, rows) = profile_step(run, warm + timed)
        top = "; ".join(
            f"{t:.2f} ms x{c} "
            f"{name.replace('void xclip::(anonymous namespace)::', '')[:60]}"
            for t, c, name in rows[:8])
        # the step's fp32 kernels by name: the products and the
        # megablock's FMA attention core (fp32 only)
        fp32 = {kind: [(t, c) for t, c, name in rows
                       if any(k in name for k in names)]
                for kind, names in FP32_STEP_KERNELS.items()}
        fp32 = {kind: (sum(t for t, _ in v), sum(c for _, c in v))
                for kind, v in fp32.items()}
        print(f"  {label}: {b * 1e3 / ms:.1f} pairs/s ({ms:.2f} ms per "
              f"step), peak {peak:.2f} GiB, idle share {idle:.4f} (device "
              f"busy {busy:.2f} of {window:.2f} ms), launches per step "
              f"{per_step}, losses "
              + " ".join(f"{x:.4f}" for x in losses.tolist()), flush=True)
        print(f"    top kernels of {total:.2f} ms: {top}", flush=True)
        print(f"    fp32 kernels of the step (SimSiam passes): "
              + "; ".join(f"{kind} {t:.2f} ms x{c}"
                          for kind, (t, c) in fp32.items())
              + "; fp32 product launches per step "
              + ", ".join(f"{e} ta={int(ta)} tb={int(tb)} {c:g}"
                          for (e, ta, tb), c in want_f32.items() if c),
              flush=True)
        return (f"{label} {b * 1e3 / ms:.1f} pairs/s ({ms:.2f} ms, peak "
                f"{peak:.2f} GiB, idle {idle:.4f}, fp32 products "
                f"{fp32['products'][0]:.2f}, fp32 attention core forward "
                f"{fp32['attention core forward'][0]:.2f} + dq "
                f"{fp32['attention core dq'][0]:.2f} + dk/dv "
                f"{fp32['attention core dk/dv'][0]:.2f} of {total:.2f} "
                "device ms)", {"products": f32, "attention": fp32})

    line, f32_stored = timed_objective(kernel, "stored", stored, want_stored,
                                       False)
    lines.append(line)

    # the SimSiam targets' passes (no_grad) take the inference forwards;
    # their outputs are bit for bit the training forwards'
    core = kernel.model
    view = default_augment(images[:few], 256, generator=step_gen(8))
    keep = torch.rand(few, 64, generator=step_gen(9),
                      device="cuda").topk(32, dim=-1).indices
    for x in (view, view.bfloat16()):
        zero_counts(stored)
        with torch.no_grad():
            lean_out = get_representation(core.visual, x, -1,
                                          attn_impl="fused", keep_idx=keep)
        with torch.enable_grad():
            train_out = get_representation(core.visual, x, -1,
                                           attn_impl="fused", keep_idx=keep)
        counts = read_counts(stored)
        if not (counts["mega"] == counts["kff"] == counts["k2_fwd"]
                == counts["k1_fwd"] == depth):
            fail(f"target pass check: launches {counts}")
        if not torch.equal(lean_out, train_out.detach()):
            fail(f"the {x.dtype} target pass on the inference forwards is "
                 "not bit for bit the training forwards' "
                 f"({(lean_out - train_out).abs().max().item():.3e})")
    lines.append("target passes on K-MEGA / K-FF bit for bit K2 / K1's "
                 "forwards (fp32 and bf16 views)")
    del kernel, core
    torch.cuda.empty_cache()

    # (b) the memory-lean routes
    lines.append(timed_objective(build(LEAN_BOTH, **OBJECTIVE_FLAGS),
                                 "lean", lean, want_lean, True)[0])
    torch.cuda.empty_cache()

    # (c) SimCLR: one step, its BatchNorm statistics folded
    m = build(STORED_BOTH, use_visual_ssl=True, visual_ssl_type="simclr",
              loss_impl="fused")
    before = bn_buffers(m)
    metrics = one_step(m, objective_draws(m, step_gen(10), text, views=1,
                                          ssl_passes=2))
    if not all(torch.isfinite(x).all() for x in metrics.values()):
        fail(f"SimCLR: a metric is not finite: {metrics}")
    if any(torch.equal(t, before[k]) for k, t in bn_buffers(m).items()):
        fail("SimCLR: BatchNorm statistics not folded")
    lines.append(f"SimCLR step: image_ssl_loss "
                 f"{metrics['image_ssl_loss'].item():.4f}, statistics "
                 "folded")
    del m
    torch.cuda.empty_cache()

    # (d) FILIP with the extra heads, dense and in blocks of 32 columns
    filip, block32 = {}, min(32, b)
    for block in (None, block32):
        m = build(STORED_BOTH, use_all_token_embeds=True,
                  extra_latent_projection=True, filip_block=block)
        if block is None:
            filip_init = {k: x.clone() for k, x in m.state_dict().items()}
        m.load_state_dict(filip_init)
        draws = objective_draws(m, step_gen(11), text, views=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 2 ** 30
        loss, grads = grads_of(m, text, images, **draws)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not (torch.isfinite(loss) and all(torch.isfinite(g).all()
                                             for g in grads.values())):
            fail(f"FILIP block {block}: the loss or a gradient is not "
                 "finite")
        filip[block] = (loss.float().item(), peak, base)
        del m, grads
        torch.cuda.empty_cache()
    (dense, dpeak, dbase), (blocked, bpeak, _) = filip[None], filip[block32]
    if not abs(dense - blocked) <= bf16_tol(dense):
        fail(f"FILIP: blocked loss {blocked:.4f} vs dense {dense:.4f}")
    if not bpeak < dpeak:
        fail(f"FILIP: blocked peak {bpeak:.2f} GiB not below dense "
             f"{dpeak:.2f}")
    lines.append(f"FILIP b={b} loss dense {dense:.4f} / blocked {block32} "
                 f"{blocked:.4f}, peak {dpeak:.2f} / {bpeak:.2f} GiB "
                 f"(weights {dbase:.2f})")

    # (e) downsampled image latents: 8 x 8 patches to 4 x 4 latent tokens
    m = build(STORED_BOTH, use_all_token_embeds=True,
              downsample_image_embeds=True, visual_patch_dropout=0.0)
    scores = m(text[:few], images[:few])
    if tuple(scores.shape) != (few, 256, 16) or not torch.isfinite(
            scores).all():
        fail(f"downsampling: scores {tuple(scores.shape)}, want ({few}, "
             "256, 16), finite")
    metrics = one_step(m, {})
    if not torch.isfinite(metrics["loss"]):
        fail("downsampling: the step's loss is not finite")
    lines.append(f"downsampling serves ({few}, 256, 16) and steps, loss "
                 f"{metrics['loss'].item():.4f}")
    del m
    torch.cuda.empty_cache()

    # (f) grad_accum=2 with SimSiam: the statistics after the step are the
    # second microbatch's fold alone, from the stored statistics
    m = build(STORED_BOTH, use_visual_ssl=True, loss_impl="fused")
    ssl_init = {k: x.clone() for k, x in m.state_dict().items()}
    micro = [objective_draws(m, step_gen(12 + i), text[:b // 2], views=1)
             for i in range(2)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step = make_train_step(m, default_optimizer(m.parameters(),
                                                    learning_rate=1e-4),
                               grad_accum=2)
    step(text, images, keep_idx=torch.cat([d["keep_idx"] for d in micro]),
         ssl_draws=[d["ssl_draws"] for d in micro])
    after = bn_buffers(m)
    m.load_state_dict(ssl_init)
    _, second = m(text[b // 2:], images[b // 2:], return_loss=True,
                  return_metrics=True, **micro[1])
    for path, (mean, var) in second["bn_updates"].items():
        for name, t in ((f"model.{path}.mean", mean),
                        (f"model.{path}.var", var)):
            if not torch.equal(after[name], t.to(after[name].dtype)):
                fail(f"grad_accum=2: {name} is not the second microbatch's "
                     "fold alone")
    lines.append(f"grad_accum=2: {len(second['bn_updates'])} BatchNorms' "
                 "statistics bit for bit the second microbatch's fold")
    del m, step, after
    torch.cuda.empty_cache()

    # (g) the golden step
    lines.append(objectives_golden(
        CLIP, load_jax_params, numpy_params, default_optimizer,
        make_train_step,
        {k: stored[k] for k in ("k2_fwd", "k2_bwd", "k1_fwd", "k1_p1",
                                "k1_p2", "mega", "kff", "k5_fwd",
                                "k5_bwd")}))
    phase(23, "objectives", f"{card}: " + "; ".join(lines))
    return f32_stored


# one rank of the 32k global batch (docs/SCALING.md): 2048 rows against the
# 32,768 gathered columns, d = 512; the ranks whose diagonal K5 masks
SHARD_R, SHARD_C, SHARD_D = 2048, 32768, 512
SHARD_OFFSETS = (0, 14336, 30720)        # ranks 0, 7 and 15 of 16
SHARD_KERNELS = [
    ("k5_fwd_shard", "K5 streaming_lse forward, one rank of the 32k batch "
     "(2048 x 32,768 x 512)", "xclip_tpu_torch/csrc/fused_infonce.cu",
     "xclip_tpu/kernels/fused_infonce.py:66"),
    ("k5_bwd_shard", "K5 streaming_lse backward (dx, dy), one rank of the "
     "32k batch (2048 x 32,768 x 512)",
     "xclip_tpu_torch/csrc/fused_infonce.cu",
     "xclip_tpu/kernels/fused_infonce.py:121"),
]


def rel_frob(got, want):
    """‖got − want‖ / ‖want‖ over lists of tensors taken as one vector."""
    num = sum(float((g.float() - w.float()).pow(2).sum())
              for g, w in zip(got, want))
    den = sum(float(w.float().pow(2).sum()) for w in want)
    return math.sqrt(num / den)


def data_parallel(card, CLIP, default_optimizer, make_train_step, lse5):
    """Phase 24: (a) the flagship's data-parallel step in a world-1 NCCL
    group beside the step without a group; (b) K5 at one rank of the 32k
    global batch; (c) an emulated 8-rank split of the b = 2048 loss.
    Returns (launches, errs, ms, costs, library) of the SHARD_KERNELS."""
    import tempfile
    import torch.distributed as dist
    from xclip_tpu_torch.objectives.contrastive import _fused_pair_losses
    from xclip_tpu_torch.parallel.collectives import all_reduce_sum_
    normalize = torch.nn.functional.normalize
    lines = []
    bf16 = torch.bfloat16

    # (a) --------------------------------------------------------------
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    group = dist.group.WORLD
    b = 256
    gen = torch.Generator(device="cuda").manual_seed(8)
    text, images = texts(gen, b), rand(gen, b, 3, 256, 256, dtype=bf16)
    model = CLIP(**FLAGSHIP, **LEAN_ROUTES, param_dtype=bf16,
                 compute_dtype="bfloat16", device="cuda", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    k5 = {"k5_fwd": lse5.streaming_lse_fwd, "k5_bwd": lse5.streaming_lse_bwd}

    def dp_step(axis_name, gather_impl, loss_impl):
        """One step from phase 8's weights, as make_train_step takes it
        (forward with the group, backward, the gradients' all-reduce,
        AdamW): (metrics, gradients, parameters after, K5 launches)."""
        model.load_state_dict(init)
        model.model.loss_impl = loss_impl
        opt = default_optimizer(model.parameters(), learning_rate=1e-4)
        opt.zero_grad(set_to_none=True)
        zero_counts(k5)
        loss, metrics = model(text, images, return_loss=True,
                              return_metrics=True, generator=step_gen(100),
                              axis_name=axis_name, gather_impl=gather_impl)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if axis_name is not None:
            all_reduce_sum_(grads, axis_name)
        metrics["grad_norm"] = opt.step()
        torch.cuda.synchronize()
        return ({k: v.detach().float() for k, v in metrics.items()},
                [g.clone() for g in grads],
                [p.detach().clone() for p in model.parameters()],
                read_counts(k5))

    for loss_impl in ("fused", "xla"):
        base = dp_step(None, "sharded", loss_impl)
        for gather_impl in ("sharded", "replicated"):
            got = dp_step(group, gather_impl, loss_impl)
            if got[3] != base[3] or base[3]["k5_fwd"] != (
                    2 if loss_impl == "fused" else 0):
                fail(f"world-1 {gather_impl} {loss_impl}: K5 launches "
                     f"{got[3]}, without a group {base[3]}")
            label = f"world-1 NCCL {gather_impl}, loss_impl='{loss_impl}'"
            if loss_impl == "fused":
                bad = [k for k in base[0]
                       if not torch.equal(got[0][k], base[0][k])]
                bad += [f"gradient {i}" for i, (g, w) in enumerate(
                    zip(got[1], base[1])) if not torch.equal(g, w)]
                bad += [f"parameter {i}" for i, (p, q) in enumerate(
                    zip(got[2], base[2])) if not torch.equal(p, q)]
                if bad or len(got[1]) != len(base[1]):
                    fail(f"{label}: not bit for bit the step without a "
                         f"group: {bad[:8]}")
                lines.append(f"{gather_impl} fused: loss, metrics, "
                             f"{len(got[1])} gradients and parameters bit "
                             "for bit")
            else:
                worst = max(abs(float(got[0][k] - base[0][k]))
                            / max(abs(float(base[0][k])), 1e-30)
                            for k in base[0] if float(base[0][k]) != 0)
                frob = rel_frob(got[1], base[1])
                # the dense blocks take i2t as its own product (not the
                # transpose of t2i), which may round otherwise in fp32;
                # bf16 gradients then within bf16's unit roundoff
                if not (worst <= 1e-6 and frob <= 2.0 ** -8):
                    fail(f"{label}: metrics {worst:.3e} relative (tol "
                         f"1e-6), gradients {frob:.3e} relative Frobenius "
                         f"(tol 2^-8)")
                lines.append(f"{gather_impl} dense: metrics {worst:.2e} "
                             f"relative (tol 1e-6), gradients {frob:.2e} "
                             "(tol 2^-8)")
            print(f"  {label}: loss {float(got[0]['loss']):.6f} (without "
                  f"a group {float(base[0]['loss']):.6f}), K5 launches "
                  f"{got[3]}", flush=True)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    reduce_ms = cuda_ms(lambda: all_reduce_sum_(grads, group))
    model.model.loss_impl = "fused"
    timed = {}
    for label, axis_name in (("none", None), ("group", group),
                             ("none2", None), ("group2", group)):
        model.load_state_dict(init)
        step = make_train_step(model, default_optimizer(
            model.parameters(), learning_rate=1e-4), axis_name=axis_name)

        def run(i):
            return step(text, images, generator=step_gen(100 + i))

        ms, counts, _, losses = timed_steps(run, 1, 3,
                                            k5 if label == "group" else {})
        check_losses(f"data-parallel step ({label})", losses, b)
        timed[label] = ms
        if label == "group":
            launches = {"k5_fwd_shard": counts["k5_fwd"],
                        "k5_bwd_shard": counts["k5_bwd"]}
            if launches != {"k5_fwd_shard": 8, "k5_bwd_shard": 8}:
                fail(f"data-parallel step: K5 launches {counts} over 4 "
                     "steps, expected 2 + 2 a step")
    dp_ms = min(timed["group"], timed["group2"])
    none_ms = min(timed["none"], timed["none2"])
    lines.append(f"step {b * 1e3 / dp_ms:.1f} pairs/s in the group, "
                 f"{b * 1e3 / none_ms:.1f} without; gradient all-reduce "
                 f"{reduce_ms:.3f} ms ({nbytes / 2 ** 20:.1f} MiB)")
    print(f"  lean step b={b}: world-1 NCCL group {dp_ms:.2f} ms "
          f"({timed['group']:.2f}, {timed['group2']:.2f}), without a group "
          f"{none_ms:.2f} ms ({timed['none']:.2f}, {timed['none2']:.2f}); "
          f"gradient all-reduce {reduce_ms:.3f} ms over {len(grads)} "
          f"gradients, {nbytes} bytes in one bf16 bucket", flush=True)
    del model, init, step, grads
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) --------------------------------------------------------------
    R, C, d = SHARD_R, SHARD_C, SHARD_D
    g = torch.Generator(device="cuda").manual_seed(24)
    x = normalize(rand(g, R, d), dim=-1) * 14.0   # rows × the temperature
    y = normalize(rand(g, C, d), dim=-1)
    dlse = rand(g, R)
    errs = {"k5_fwd_shard": 0.0, "k5_bwd_shard": 0.0}
    for offset in SHARD_OFFSETS:
        for dcl in (False, True):
            tag = f"K5 (2048, 32768, 512) row_offset {offset} DCL {dcl}"
            lse = lse5.streaming_lse_fwd(x, y, offset, dcl)
            want = lse5.streaming_lse_fwd_plain(x, y, offset, dcl)
            errs["k5_fwd_shard"] = max(errs["k5_fwd_shard"], compare(
                f"{tag} lse", lse, want, 1e-4))
            got = lse5.streaming_lse_bwd(x, y, want, dlse, offset, dcl)
            wgrad = lse5.streaming_lse_bwd_plain(x, y, want, dlse, offset,
                                                 dcl)
            errs["k5_bwd_shard"] = max(errs["k5_bwd_shard"], *(
                compare(f"{tag} {name}", gg, w, 1e-4 * float(w.abs().max()))
                for name, gg, w in zip(("dx", "dy"), got, wgrad)))
            del lse, want, got, wgrad
    offset = SHARD_OFFSETS[-1]
    want = lse5.streaming_lse_fwd_plain(x, y, offset, False)
    ms = {"k5_fwd_shard": (
        cuda_ms(lambda: lse5.streaming_lse_fwd(x, y, offset, False)),
        cuda_ms(lambda: lse5.streaming_lse_fwd_plain(x, y, offset, False))),
        "k5_bwd_shard": (
        cuda_ms(lambda: lse5.streaming_lse_bwd(x, y, want, dlse, offset,
                                               False)),
        cuda_ms(lambda: lse5.streaming_lse_bwd_plain(x, y, want, dlse,
                                                     offset, False)))}
    library = {"k5_fwd_shard": cuda_ms(
        lambda: torch.logsumexp(x @ y.T, dim=-1)), "k5_bwd_shard": None}
    costs = {"k5_fwd_shard": lse_cost("fwd", R, C, d),
             "k5_bwd_shard": lse_cost("bwd", R, C, d)}
    for key in ms:
        b_ms, b_by = bound(*costs[key], FP32_PEAK)
        lib = ("" if library[key] is None else
               f", logsumexp(x @ y.T) {library[key]:.3f} ms")
        print(f"  {key}: kernel {ms[key][0]:.3f} ms, plain "
              f"{ms[key][1]:.3f} ms{lib}, bound {b_ms:.3f} ms ({b_by})",
              flush=True)
    lines.append(f"K5 at (2048, 32768, 512), row offsets "
                 f"{list(SHARD_OFFSETS)} with and without DCL: fwd "
                 f"{ms['k5_fwd_shard'][0]:.3f} ms, bwd "
                 f"{ms['k5_bwd_shard'][0]:.3f} ms")
    del x, y, dlse, want
    torch.cuda.empty_cache()

    # (c) --------------------------------------------------------------
    B, ranks = 2048, 8
    lat = [normalize(rand(g, B, 512), dim=-1) for _ in range(4)]
    temp = torch.tensor(14.0, device="cuda")

    def split_loss(parts):
        """(the summed loss, the gradients of text, image, text extra,
        image extra): each part's rows against every column at its row
        offset, one backward through all of them (the rows' gradients
        land in their own rows; the columns' add up over the parts, as
        the reduce-scatter adds them)."""
        tl, il, tx, ix = leaves = [t.clone().requires_grad_() for t in lat]
        total = sum(_fused_pair_losses(
            tl[None, rows], il[None], ix[None, rows], tx[None], temp, True,
            offset, global_batch, None)[0]
            for rows, offset, global_batch in parts)
        total.backward()
        return total.detach(), [t.grad for t in leaves]

    whole, whole_g = split_loss([(slice(None), 0, None)])
    per = B // ranks
    split, split_g = split_loss([(slice(per * r, per * (r + 1)), per * r, B)
                                 for r in range(ranks)])
    loss_rel = abs(float(split - whole)) / abs(float(whole))
    grad_rel = rel_frob(split_g, whole_g)
    if not (loss_rel <= 1e-6 and grad_rel <= 1e-4):
        fail(f"8-rank split of the b = 2048 K5 loss: loss {loss_rel:.3e} "
             f"relative (tol 1e-6), gradients {grad_rel:.3e} relative "
             "Frobenius (tol 1e-4)")
    lines.append(f"8-rank split of b=2048 (DCL, extra heads): loss "
                 f"{loss_rel:.2e} relative, gradients {grad_rel:.2e}")
    del lat, whole_g, split_g
    torch.cuda.empty_cache()
    phase(24, "data-parallel", f"{card}: " + "; ".join(lines))
    return launches, errs, ms, costs, library


def tensor_parallel(card, CLIP, default_optimizer, make_train_step, ffb,
                    mega, phase8):
    """Phase 26: (a) phase 8's flagship step on a (1, 1) mesh beside the
    step without one; (b) the torch dryrun at one NCCL rank."""
    import tempfile
    import torch.distributed as dist
    from xclip_tpu_torch.dryrun import dryrun_multichip
    from xclip_tpu_torch.parallel import create_mesh
    from xclip_tpu_torch.train import shard_batch, shard_state
    bf16 = torch.bfloat16
    lines = []

    # (a) --------------------------------------------------------------
    b = 256
    gen = torch.Generator(device="cuda").manual_seed(8)   # phase 8's batch
    text, images = texts(gen, b), rand(gen, b, 3, 256, 256, dtype=bf16)
    counters = {"k1_fwd": ffb.ff_block_fwd_stored,
                "k1_p1": ffb.ff_block_bwd_p1, "k1_p2": ffb.ff_block_bwd_p2,
                "k2_fwd": mega.attention_block_fwd_stored,
                "k2_bwd": mega.attention_block_bwd}
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    mesh = create_mesh((1, 1))
    runs = {}
    for label in ("without a mesh", "mesh (1, 1)"):
        model = CLIP(**FLAGSHIP, **KERNEL_ROUTES, param_dtype=bf16,
                     compute_dtype="bfloat16", device="cuda", seed=0)
        opt = default_optimizer(model.parameters(), learning_rate=1e-4)
        t, i, kw = text, images, {}
        if label != "without a mesh":
            shard_state(model, opt, mesh)
            t, i = shard_batch((text, images), mesh)
            kw = dict(mesh=mesh)
        step = make_train_step(model, opt, **kw)
        zero_counts(counters)
        m = step(t, i, generator=step_gen(100))   # phase 8's first draw
        torch.cuda.synchronize()
        counts = read_counts(counters)
        after = ({k: v.detach().float() for k, v in m.items()},
                 [p.detach().clone() for p in model.parameters()],
                 [opt.state[p][k].clone() for p in model.parameters()
                  for k in ("mu", "nu")])
        nbytes = sum(t.numel() * t.element_size()
                     for t in [*after[1], *after[2]])
        runs[label] = dict(step=step, after=after, counts=counts,
                           nbytes=nbytes, t=t, i=i)
    base, got = runs["without a mesh"], runs["mesh (1, 1)"]
    bad = [k for k in base["after"][0]
           if not torch.equal(got["after"][0][k], base["after"][0][k])]
    bad += [f"parameter {n}" for n, (p, q) in enumerate(zip(
        got["after"][1], base["after"][1])) if not torch.equal(p, q)]
    bad += [f"moment {n}" for n, (p, q) in enumerate(zip(
        got["after"][2], base["after"][2])) if not torch.equal(p, q)]
    if bad:
        fail(f"mesh (1, 1) step: not bit for bit the step without a mesh: "
             f"{bad[:8]}")
    if float(base["after"][0]["loss"]) != float(phase8[5][0]):
        fail(f"the step without a mesh: loss "
             f"{float(base['after'][0]['loss'])!r}, phase 8's first "
             f"{float(phase8[5][0])!r}")
    if got["counts"] != base["counts"] or min(got["counts"].values()) < 1:
        fail(f"mesh (1, 1) launches {got['counts']}, without a mesh "
             f"{base['counts']}")
    # the two steps timed in turns, 1 warm-up and 3 timed steps each
    ms = {label: [] for label in runs}
    for _ in range(2):
        for label, r in runs.items():
            ms[label].append(timed_steps(
                lambda j, r=r: r["step"](r["t"], r["i"],
                                         generator=step_gen(101 + j)),
                1, 3, {})[0])
    rate = {label: b * 1e3 / min(v) for label, v in ms.items()}
    print(f"  {card}: flagship b={b} bf16 stored kernel routes, one step: "
          f"mesh (1, 1) bit for bit the step without a mesh (loss "
          f"{float(got['after'][0]['loss']):.6f} = phase 8's first, "
          f"grad_norm {float(got['after'][0]['grad_norm']):.6f}, "
          f"{len(got['after'][1])} parameters, {len(got['after'][2])} "
          f"moments); launches K1 fwd/p1/p2 {got['counts']['k1_fwd']}/"
          f"{got['counts']['k1_p1']}/{got['counts']['k1_p2']}, K2 fwd/bwd "
          f"{got['counts']['k2_fwd']}/{got['counts']['k2_bwd']} (without "
          f"a mesh the same; phase 8: 12/12/12, 6/6 a step)", flush=True)
    print(f"  {card}: pairs/s mesh (1, 1) {rate['mesh (1, 1)']:.1f}, "
          f"without a mesh {rate['without a mesh']:.1f} (best of 2 x 3 "
          f"steps each, in turns), phase 8 {b * 1e3 / phase8[0]:.1f}; "
          f"parameters + AdamW moments on the rank {got['nbytes']} bytes "
          f"({got['nbytes'] / 2 ** 20:.1f} MiB)", flush=True)
    lines.append(f"flagship mesh (1, 1) step bit for bit, "
                 f"{rate['mesh (1, 1)']:.1f} pairs/s (without a mesh "
                 f"{rate['without a mesh']:.1f}, phase 8 "
                 f"{b * 1e3 / phase8[0]:.1f}), {got['nbytes']} bytes of "
                 "parameters and moments")
    # (c) --------------------------------------------------------------
    # `model` and `opt` are the (1, 1) mesh's, after (a)'s timed steps
    lines.append(checkpoint_both_ways(CLIP, default_optimizer, mesh, model,
                                      opt, os.path.join(store, "ckpt")))
    del runs, base, got, model, opt, step
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) --------------------------------------------------------------
    try:
        dryrun_multichip(torch.cuda.device_count() + 1, device="cuda")
        fail("dryrun_multichip past the device count did not raise")
    except ValueError as e:
        print(f"  dryrun_multichip({torch.cuda.device_count() + 1}): "
              f"ValueError: {e}", flush=True)
    t0 = time.perf_counter()
    res = dryrun_multichip(1, device="cuda")
    seconds = time.perf_counter() - t0
    want = {"fused_loss_sharded": ("K5",),
            "pallas_kernels_train_step(tp2)": ("K2", "K1"),
            "memory_lean_train_step": ("K3", "K-FF-s", "K5")}
    if len(res["losses"]) != 9:
        fail(f"dryrun: {len(res['losses'])} stages, not 9")
    for name, kernels in want.items():
        got = res["launches"].get(name, {})
        if any(got.get(k, 0) < 1 for k in kernels):
            fail(f"dryrun stage {name}: launches {got}, expected "
                 f"{kernels} each at least once")
    lines.append(f"dryrun_multichip(1) on NCCL: 9 stages in {seconds:.1f} s,"
                 " launches " + "; ".join(
                     f"{k} " + " ".join(f"{n}={c}" for n, c in
                                        res["launches"][k].items())
                     for k in want))
    phase(26, "tensor-parallel", f"{card}: " + "; ".join(lines))


def checkpoint_both_ways(CLIP, default_optimizer, mesh, meshed, meshed_opt,
                         path):
    """Phase 26 (c): the collective save of a model and AdamW placed on the
    (1, 1) `mesh` restored into a fresh pair with no mesh, and the fresh
    pair's save restored into another placed on `mesh`: parameters,
    moments and count bit for bit both ways."""
    from xclip_tpu_torch.train import (restore_checkpoint, save_checkpoint,
                                       shard_state)

    def fresh(on_mesh):
        m = CLIP(**FLAGSHIP, **KERNEL_ROUTES, param_dtype=torch.bfloat16,
                 compute_dtype="bfloat16", device="cuda", seed=5)
        o = default_optimizer(m.parameters(), learning_rate=1e-4)
        if on_mesh:
            shard_state(m, o, mesh)
        return m, o

    def differ(a, ao, b, bo):
        pairs = list(zip(a.named_parameters(), b.parameters()))
        bad = [n for (n, p), q in pairs if not torch.equal(p, q)]
        bad += [f"{n} {k}" for (n, p), q in pairs for k in ("mu", "nu")
                if not torch.equal(ao.state[p][k], bo.state[q][k])]
        return bad + (["count"] if ao.count != bo.count else [])

    t0 = time.perf_counter()
    count = meshed_opt.count
    save_checkpoint(path, meshed, meshed_opt, step=count)
    plain, plain_opt = fresh(False)
    got = restore_checkpoint(path, plain, plain_opt)
    bad = differ(meshed, meshed_opt, plain, plain_opt)
    if got != count or bad:
        fail(f"the (1, 1) mesh's checkpoint restored with no mesh: step "
             f"{got}, not bit for bit: {bad[:8]}")
    save_checkpoint(path, plain, plain_opt, step=count)
    back, back_opt = fresh(True)
    restore_checkpoint(path, back, back_opt)
    bad = differ(plain, plain_opt, back, back_opt)
    if bad:
        fail(f"a checkpoint with no mesh restored on the (1, 1) mesh: not "
             f"bit for bit: {bad[:8]}")
    seconds = time.perf_counter() - t0
    size = os.path.getsize(path)
    n = sum(1 for _ in meshed.parameters())
    print(f"  checkpoint of the (1, 1) mesh's state ({size / 2 ** 20:.1f} "
          f"MiB): saved collectively over NCCL, restored with no mesh and "
          f"back onto the mesh, {n} parameters, {2 * n} moments and the "
          f"count bit for bit both ways ({seconds:.1f} s)", flush=True)
    return ("checkpoint (1, 1) mesh -> no mesh -> (1, 1) mesh bit for bit "
            f"({size / 2 ** 20:.1f} MiB)")


def examples_phase(card, ffb, mega, lse5, steps=300):
    """Phase 28: the port's training example on the kernel routes for
    `steps` steps, and the zero-shot example."""
    import tempfile
    from xclip_tpu_torch.examples import train, zero_shot
    counters = {"k2_fwd": mega.attention_block_fwd_stored,
                "k2_bwd": mega.attention_block_bwd,
                "k1_fwd": ffb.ff_block_fwd_stored,
                "k1_p1": ffb.ff_block_bwd_p1, "k1_p2": ffb.ff_block_bwd_p2,
                "k5_fwd": lse5.streaming_lse_fwd,
                "k5_bwd": lse5.streaming_lse_bwd}
    work = tempfile.mkdtemp()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zero_counts(counters)
        out = train.main(steps, os.path.join(work, "metrics.jsonl"),
                         device="cuda",
                         checkpoint_path=os.path.join(work, "ckpt"),
                         attn_impl="fused", ff_impl="block_stored",
                         loss_impl="fused")
        torch.cuda.synchronize()
        counts = read_counts(counters)
    seconds = time.perf_counter() - t0
    fallbacks = [str(w.message) for w in caught
                 if "falling back to the XLA path" in str(w.message)]
    if fallbacks:
        fail(f"examples: fallback warnings {fallbacks}")
    per_step = {k: v / steps for k, v in counts.items()}
    if min(counts.values()) < 1:
        fail(f"examples: a kernel was not launched: {counts}")
    first, last = out["first"]["cl_loss"], out["last"]["cl_loss"]
    if not last < first:
        fail(f"examples: cl_loss {first:.4f} -> {last:.4f} did not fall")
    if not out["top1"] > out["top1_init"]:
        fail(f"examples: zero-shot top-1 {out['top1_init']:.3f} -> "
             f"{out['top1']:.3f} did not rise")
    if not out["restored_equal"]:
        fail("examples: the restored checkpoint's zero-shot logits differ")
    with open(out["metrics_path"]) as f:
        logged = sum(1 for _ in f)
    print(f"  {card}: training example, {steps} steps at b=64 bf16 on K2, "
          f"K1 and K5: cl_loss {first:.4f} (first step) -> {last:.4f} "
          f"(last), zero-shot top-1 {out['top1_init']:.3f} -> "
          f"{out['top1']:.3f} (the JAX package's example on a TPU v5e, "
          f"docs/RUN.md: 0.027 -> 0.816 in 300 steps; an accuracy, no "
          f"time of this card); {out['pairs_per_s']:.1f} pairs/s over "
          f"steps 2-{steps} ({out['seconds']:.1f} s, loader included), "
          f"{seconds:.1f} s in all with the evals and the checkpoint; "
          f"launches a step {per_step}; {logged} lines of metrics; the "
          f"restored checkpoint's logits bit for bit", flush=True)
    classifier, acc = zero_shot.main(device="cuda")
    if tuple(classifier.shape) != (3, 128) or not (
            torch.isfinite(classifier).all() and 0.0 <= acc["top1"] <= 1.0):
        fail(f"zero-shot example: classifier {tuple(classifier.shape)}, "
             f"top-1 {acc}")
    phase(28, "examples", f"{card}: training example {steps} steps bf16 "
          f"(K2 {per_step['k2_fwd']:g}/{per_step['k2_bwd']:g}, K1 "
          f"{per_step['k1_fwd']:g}/{per_step['k1_p1']:g}/"
          f"{per_step['k1_p2']:g}, K5 {per_step['k5_fwd']:g}/"
          f"{per_step['k5_bwd']:g} a step): cl_loss {first:.4f} -> "
          f"{last:.4f}, zero-shot top-1 {out['top1_init']:.3f} -> "
          f"{out['top1']:.3f} (JAX on a TPU v5e: 0.816), "
          f"{out['pairs_per_s']:.1f} pairs/s, checkpoint restored bit for "
          f"bit; zero-shot example classifier (3, 128), top-1 "
          f"{acc['top1']:.3f}")
    return out


GOLDEN_TOKENS = GOLDEN.with_name("torch_port_golden_tokens.npz")
# words of other scripts that phase 25's captions mix in, one word in eight
OTHER_WORDS = ("café", "naïve", "Straße", "ünïcode", "Ωμέγα", "привет",
               "مرحبا", "क्या", "日本語", "한국어", "😀", "🧠🚀", "½", "Ⅻ",
               "don't", "it's", "¡hola!", "&amp;")


def data_captions(tok, n, seed):
    """`n` seeded captions, the i-th starting with i, then 5-60 words:
    whole-word entries of the BPE vocabulary, one in eight from
    OTHER_WORDS, now and then capitalised, a number or punctuation."""
    npr = np.random.RandomState(seed)
    vocab = sorted(w[:-4] for w in tok.encoder
                   if w.endswith("</w>") and w[:-4].isascii()
                   and w[:-4].isalpha())
    out = []
    for i in range(n):
        words = []
        for _ in range(npr.randint(5, 61)):
            u = npr.rand()
            w = (OTHER_WORDS[npr.randint(len(OTHER_WORDS))] if u < 0.125
                 else str(npr.randint(10 ** 4)) if u < 0.2
                 else "!?.,-"[npr.randint(5)] if u < 0.25
                 else vocab[npr.randint(len(vocab))])
            words.append(w.capitalize() if npr.rand() < 0.1 else w)
        out.append(f"{i} " + " ".join(words))
    return out


class DataPairs:
    """(caption, image) pairs: caption i of `captions`, image i mod the
    images given (256-px fp32 CHW arrays; no decode, so the phase needs
    no PIL)."""

    def __init__(self, captions, images):
        self.captions, self.images = captions, images

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i):
        return self.captions[i], self.images[i % len(self.images)]


def profiled(fn, tries=4):
    """`fn()` under torch.profiler (CPU and CUDA): the profile of the first
    try whose device events are not empty (one sometimes comes back
    without them)."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        if device_events(prof):
            return prof
    fail(f"the profiler saw no device activity in {tries} profiles")


def same_batch(label, got, want):
    """A batch on the card against its host collate, bit for bit."""
    if got.keys() != want.keys() or got["loader_state"] != want[
            "loader_state"]:
        fail(f"{label}: keys or loader_state differ: {sorted(got)} "
             f"{got['loader_state']} against {want['loader_state']}")
    for k in got:
        if k == "loader_state":
            continue
        g, w = got[k], want[k]
        if not g.is_cuda or g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label}: '{k}' {g.device} {g.dtype} {tuple(g.shape)}, "
                 f"host {w.dtype} {tuple(w.shape)}")
        g = g.cpu()
        if g.dtype.is_floating_point:
            g, w = (t.view({2: torch.int16, 4: torch.int32}[t.itemsize])
                    for t in (g, w))
        if not torch.equal(g, w):
            fail(f"{label}: '{k}' is not bit for bit its host collate")


def data_pipeline(card, CLIP, default_optimizer, make_train_step, ffb, mega):
    """Phase 25: (a) the tokenizer's native merge loop against its Python
    loop and the golden ids; (b) TextImageLoader alone at b = 256; (c) the
    flagship (vocabulary 49,408) trained from it."""
    from xclip_tpu_torch.data import SimpleTokenizer, TextImageLoader
    from xclip_tpu_torch.data import pipeline
    from xclip_tpu_torch.native import fast_bpe
    lines = []

    # (a) ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = fast_bpe.build()
    build_s = time.perf_counter() - t0
    native, python = SimpleTokenizer(), SimpleTokenizer(use_native=False)
    if native._native is None or python._native is not None:
        fail("SimpleTokenizer() does not run the native merge loop")
    caps = data_captions(native, 4096, 25)
    ids, rates = {}, {}
    for name, tok in (("native", native), ("python", python)):
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            ids[name] = [tok.encode(c) for c in caps]
            rates[name, run] = len(caps) / (time.perf_counter() - t0)
    if ids["native"] != ids["python"]:
        bad = [i for i, (a, b) in enumerate(zip(ids["native"],
                                                ids["python"])) if a != b]
        fail(f"native and Python merge loops differ on {len(bad)} of 4096 "
             f"captions, first {caps[bad[0]]!r}")
    g = np.load(GOLDEN_TOKENS)
    cb, co, gi, io = (g["caption_bytes"], g["caption_offsets"], g["ids"],
                      g["id_offsets"])
    for i in range(len(co) - 1):
        text = bytes(cb[co[i]:co[i + 1]]).decode("utf-8")
        want = gi[io[i]:io[i + 1]].tolist()
        for tok in (native, python):
            if tok.encode(text) != want:
                fail(f"golden caption {i} {text!r}: {tok.encode(text)} "
                     f"against JAX's {want}")
    n_tokens = sum(map(len, ids["native"]))
    print(f"  tokenizer: g++ build {build_s:.1f} s ({lib.name}); 4096 "
          f"captions ({n_tokens} ids): native {rates['native', 'cold']:.0f}"
          f" captions/s cold, {rates['native', 'warm']:.0f} warm; Python "
          f"{rates['python', 'cold']:.0f} cold, {rates['python', 'warm']:.0f}"
          f" warm; {len(co) - 1} golden captions equal JAX's ids",
          flush=True)
    lines.append(f"tokenizer native {rates['native', 'warm']:.0f} / Python "
                 f"{rates['python', 'warm']:.0f} captions/s warm "
                 f"({rates['native', 'cold']:.0f} / "
                 f"{rates['python', 'cold']:.0f} cold), golden ids equal")

    # (b) ---------------------------------------------------------------
    b = 256
    npr = np.random.RandomState(25)
    images = [npr.randn(3, 256, 256).astype(np.float32) for _ in range(64)]
    pairs = DataPairs(data_captions(native, 2048, 26), images)
    loader_kw = dict(tokenizer=native, num_workers=4, prefetch=2)
    cases = [("float32", pairs, {}), ("bfloat16", pairs, {}),
             ("float32 pad", DataPairs(pairs.captions[:2000], images),
              dict(drop_remainder=False, pad_remainder=True))]
    pinned, staged = [], {}
    real_staging = pipeline._staging_batch

    def spy(*args, **kw):
        """The loader's staging buffers: whether each is pinned, and the
        last one."""
        staged["last"] = real_staging(*args, **kw)
        pinned.extend(t.is_pinned() for t in staged["last"].values())
        return staged["last"]

    for label, ds, kw in cases:
        dtype = label.split()[0]
        kw = {**loader_kw, **kw, "image_dtype": dtype}
        runs = []
        for run in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(pipeline, "_staging_batch", spy):
                got = list(TextImageLoader(ds, b, **kw))
            torch.cuda.synchronize()
            runs.append(len(ds) / (time.perf_counter() - t0))
        want = list(TextImageLoader(ds, b, device="cpu", **kw))
        if not len(got) == len(want) == 8:
            fail(f"loader {label}: {len(got)} batches, host {len(want)}")
        for i, (gb, wb) in enumerate(zip(got, want)):
            same_batch(f"loader {label} batch {i}", gb, wb)
        if "pad" in label and int(got[-1]["valid"].sum()) != 2000 - 7 * b:
            fail(f"loader {label}: last batch valid rows "
                 f"{int(got[-1]['valid'].sum())}, expected {2000 - 7 * b}")
        keys = [k for k in got[0] if k != "loader_state"]
        del got, want
        # the loader's copies re-enacted: the same non_blocking copies of
        # one batch from its pinned staging buffer, on the default stream
        # (the profiler drops copies of a loader run)
        host = staged["last"]
        h2d = cuda_ms(lambda: [host[k].to("cuda", non_blocking=True)
                               for k in keys])
        mb = sum(host[k].numel() * host[k].itemsize for k in keys) / 1e6
        # the producer's collate of one batch into that staging buffer,
        # from captions (tokenized in it) and from their ids
        loader = TextImageLoader(ds, b, device="cpu", **kw)
        caps_b = [ds[i][0] for i in range(b)]
        imgs_b = [ds[i][1] for i in range(b)]
        ids_b = list(native.tokenize(caps_b, context_length=256,
                                     truncate_text=True,
                                     pad_to_context_length=True))
        collate = {}
        for name, texts in (("captions", caps_b), ("ids", ids_b)):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                loader._collate(texts, imgs_b, host)
                times.append((time.perf_counter() - t0) * 1e3)
            collate[name] = statistics.median(times)
        print(f"  loader {label}: {runs[0]:.0f} pairs/s first run, "
              f"{runs[1]:.0f} second; host-to-device (the loader's copies "
              f"re-enacted on the default stream) {h2d:.3f} ms a batch "
              f"({mb:.1f} MB from pinned memory, {mb / h2d:.2f} GB/s); "
              f"collate into pinned memory {collate['captions']:.2f} ms a "
              f"batch from captions, {collate['ids']:.2f} from ids; 8 "
              "batches bit for bit their host collate", flush=True)
        lines.append(f"loader {label} {runs[1]:.0f} pairs/s, H2D "
                     f"(re-enacted) {h2d:.3f} ms, collate "
                     f"{collate['captions']:.2f} / {collate['ids']:.2f} ms "
                     "a batch")
    if not pinned or not all(pinned):
        fail(f"{pinned.count(False)} of {len(pinned)} staging buffers are "
             "not pinned")
    del staged

    # (c) ---------------------------------------------------------------
    warm, timed, profiles = 2, 6, 4
    model = CLIP(**{**FLAGSHIP, "num_text_tokens": 49408}, **KERNEL_ROUTES,
                 param_dtype=torch.bfloat16, compute_dtype="bfloat16",
                 device="cuda", seed=0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, default_optimizer(model.parameters(),
                                                    learning_rate=1e-4))
    kw = {**loader_kw, "image_dtype": "bfloat16"}
    counters = {"k1_fwd": ffb.ff_block_fwd_stored,
                "k1_p1": ffb.ff_block_bwd_p1, "k1_p2": ffb.ff_block_bwd_p2,
                "k2_fwd": mega.attention_block_fwd_stored,
                "k2_bwd": mega.attention_block_bwd}
    it = iter(TextImageLoader(pairs, b, num_epochs=None, **kw))
    torch.cuda.synchronize()
    zero_counts(counters)
    batches, metrics = [], []
    for i in range(warm + timed):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        batch = next(it)
        metrics.append(step(batch["text"], batch["image"],
                            generator=step_gen(100 + i)))
        batches.append(batch)
    torch.cuda.synchronize()
    composed_ms = (time.perf_counter() - t0) * 1e3 / timed
    per_step = {k: v / (warm + timed)
                for k, v in read_counts(counters).items()}
    want = {"k1_fwd": 12, "k1_p1": 12, "k1_p2": 12, "k2_fwd": 6,
            "k2_bwd": 6}
    if per_step != want:
        fail(f"loader-fed steps: launches per step {per_step}, expected "
             f"{want}")
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    check_losses("loader-fed steps", losses, b)

    def idle(run):
        shares = [idle_share(profiled(run))[0] for _ in range(profiles)]
        return statistics.median(shares[1:]), shares[1:]

    def composed_step():
        batch = next(it)
        step(batch["text"], batch["image"], generator=step_gen(7))

    composed_idle = idle(composed_step)
    it.close()
    # the same step on batches already on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches[warm:]):
        step(batch["text"], batch["image"], generator=step_gen(200 + i))
    torch.cuda.synchronize()
    resident_ms = (time.perf_counter() - t0) * 1e3 / timed
    resident_idle = idle(lambda: step(batches[-1]["text"],
                                      batches[-1]["image"],
                                      generator=step_gen(7)))

    # the first step again, on the host collate of its batch placed by a
    # synchronous .to('cuda'), from the same weights and generator
    host = next(iter(TextImageLoader(pairs, b, device="cpu", **kw)))
    same_batch("first loader-fed batch", batches[0], host)
    model.load_state_dict(init)
    step = make_train_step(model, default_optimizer(model.parameters(),
                                                    learning_rate=1e-4))
    again = step(host["text"].to("cuda"), host["image"].to("cuda"),
                 generator=step_gen(100))
    bad = [k for k in metrics[0] if not torch.equal(metrics[0][k], again[k])]
    if bad or metrics[0].keys() != again.keys():
        fail(f"the first loader-fed step differs from the same step on a "
             f"synchronously placed batch in {bad}")
    print(f"  composed (loader -> flagship step, b={b}, bf16 images): "
          f"{b * 1e3 / composed_ms:.1f} pairs/s ({composed_ms:.2f} ms a "
          f"step), idle share median {composed_idle[0]:.4f} of "
          + " ".join(f"{s:.4f}" for s in composed_idle[1])
          + f"; device-resident batches {b * 1e3 / resident_ms:.1f} pairs/s "
          f"({resident_ms:.2f} ms), idle {resident_idle[0]:.4f} of "
          + " ".join(f"{s:.4f}" for s in resident_idle[1])
          + "; first step's loss and metrics bit for bit the synchronously "
          f"placed step's (loss {float(again['loss']):.6f}); launches per "
          "step K1 fwd/p1/p2 12, K2 fwd/bwd 6", flush=True)
    lines.append(f"composed {b * 1e3 / composed_ms:.1f} pairs/s (idle "
                 f"{composed_idle[0]:.4f}) against device-resident "
                 f"{b * 1e3 / resident_ms:.1f} (idle {resident_idle[0]:.4f})"
                 "; first step bit for bit")
    del model, step, batches, it
    torch.cuda.empty_cache()
    phase(25, "data", f"{card}: " + "; ".join(lines))


# ------------------------------------------------------------------- 27
# A CLIP at the widths of OpenCLIP's ViT-H-14.json in the repo's own terms:
# vision 1280 wide, 16 heads of 80 (zero-padded to 128 on the kernels),
# 224-px images in 14-px patches (256 patches and CLS), 32 layers; text
# 1024 wide, 16 heads of 64, 77 tokens, 49,408 ids, 24 layers; latents
# 1024. The FF is the repo's GEGLU at 4x (5,120 and 4,096 inner), not
# OpenCLIP's GELU MLP; FLIP patch dropout the repo's 0.5 in training.
VIT_H = dict(dim_image=1280, visual_heads=16, visual_dim_head=80,
             visual_image_size=224, visual_patch_size=14, visual_enc_depth=32,
             dim_text=1024, text_heads=16, text_dim_head=64, text_seq_len=77,
             num_text_tokens=49408, text_enc_depth=24, dim_latent=1024)
VIT_H_ROUTES = dict(attn_impl="fused", visual_attn_impl=None,
                    ff_impl="block_stored")


# one run of phase 27's model in a process of its own, from the root of
# the checkout whose `xclip_tpu_torch` it runs (argv[1]), measured by the
# `vit_h_turn` of this file (argv[2])
VIT_H_TURN = """
import importlib.util, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
smoke.vit_h_turn()
"""


def vit_h_turn():
    """One run of phase 27's model (VIT_H on its kernel routes, bf16, seed
    27, b = 64) by the `xclip_tpu_torch` first on sys.path: 1 + 3 served
    batches (CUDA events over the 3), 1 + 3 AdamW steps (CUDA events over
    the 3, peak memory over all 4), then one step profiled after a warm-up
    one: its device busy ms, idle share and device ms by kernel. Prints
    one JSON line."""
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch.train import default_optimizer, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, b = torch.bfloat16, 64
    gen = torch.Generator(device="cuda").manual_seed(27)
    text = texts(gen, b, seq=77, vocab=49408)
    images = rand(gen, b, 3, 224, 224, dtype=bf16)
    model = CLIP(**VIT_H, **VIT_H_ROUTES, param_dtype=bf16,
                 compute_dtype="bfloat16", device="cuda", seed=27)
    with torch.no_grad():
        model(text, images, return_latents=True)
        serve_ms = cuda_ms(lambda: model(text, images, return_latents=True),
                           reps=1, iters=3)
    step = make_train_step(model, default_optimizer(model.parameters(),
                                                    learning_rate=1e-4))

    def run(i):
        return step(text, images, generator=torch.Generator(
            device="cuda").manual_seed(270 + i))

    step_ms, _, peak, losses = timed_steps(run, 1, 3, {})
    (idle, busy, window), (_, kernels) = profile_step(run, 4)
    print(json.dumps({
        "serve": b * 1e3 / serve_ms, "train": b * 1e3 / step_ms,
        "peak": peak, "idle": idle, "busy_ms": busy, "window_ms": window,
        "loss": losses[0].item(),
        "kernels": {name: [ms, count] for ms, count, name in kernels}}))


def vit_h_turns(parent):
    """Phase 27's model run by the older checkout at `parent` and by this
    one in turns, parent, this, this, parent, each run a process of its
    own (`vit_h_turn`: neither side inherits the other's allocator, and
    neither always runs first). Prints a line a run, the kernels whose
    device time a step moved most between the two sides' means, and each
    side's medians."""
    sides = {"parent": parent, "this": ROOT}
    results = {name: [] for name in sides}
    for turn, name in enumerate(("parent", "this", "this", "parent")):
        run = subprocess.run(
            [sys.executable, "-c", VIT_H_TURN, str(sides[name]),
             str(Path(__file__).resolve())], cwd=sides[name],
            capture_output=True, text=True, timeout=900)
        if run.returncode:
            fail(f"phase 27's {name} run exited {run.returncode}: "
                 f"{run.stderr[-2000:]}")
        r = json.loads(run.stdout.strip().splitlines()[-1])
        results[name].append(r)
        print(f"  turn {turn} {name:6s}: serving {r['serve']:.1f} pairs/s, "
              f"training {r['train']:.1f} pairs/s, peak {r['peak']:.2f} GiB,"
              f" profiled step busy {r['busy_ms']:.2f} of "
              f"{r['window_ms']:.2f} ms (idle {r['idle']:.4f}), first loss "
              f"{r['loss']:.4f}", flush=True)
    means = {name: collections.Counter() for name in sides}
    for name, runs in results.items():
        for r in runs:
            for kernel, (ms, _) in r["kernels"].items():
                means[name][kernel] += ms / len(runs)
    moved = sorted(set(means["parent"]) | set(means["this"]),
                   key=lambda k: -abs(means["this"][k] - means["parent"][k]))
    for kernel in moved[:12]:
        p, t = means["parent"][kernel], means["this"][kernel]
        print(f"  {t - p:+8.2f} ms a step: {kernel[:110]} (parent {p:.2f}, "
              f"this {t:.2f})", flush=True)
    for name, runs in results.items():
        print(f"  median {name}: serving "
              f"{statistics.median(r['serve'] for r in runs):.1f} pairs/s, "
              f"training {statistics.median(r['train'] for r in runs):.1f} "
              f"pairs/s, peak {statistics.median(r['peak'] for r in runs):.2f}"
              f" GiB, device busy "
              f"{statistics.median(r['busy_ms'] for r in runs):.2f} ms a step",
              flush=True)


def vit_h(card, CLIP, default_optimizer, make_train_step, ffb, mega,
          parent=None):
    """Phase 27: the ViT-H/14-width CLIP (VIT_H), bf16, seed 27, served and
    trained at full depth (32 + 24 layers) on the kernel routes at b = 64:
    serving (a warm-up, then 3 timed forwards to latents) with every
    layer's K-MEGA and K-FF launched (the vision tower's K-MEGA at its
    heads' true width of 80, qkv 3,840 columns, with no pad_heads call),
    pairs/s; at b = 4 the latents against the plain routes' on the same
    weights (bf16 3e-2, as phase 21); then 1 warm-up and 3 timed AdamW
    steps of K2 and K1 (stored): pairs/s, peak memory, finite losses, the
    first within 0.5 of ln 64, launches per step; no fallback warning
    anywhere. With `parent` (an older checkout) the model is first run by
    both checkouts in turns (`vit_h_turns`)."""
    from xclip_tpu_torch.kernels._common import kernel_width
    if parent is not None:
        torch.cuda.empty_cache()
        vit_h_turns(parent)
    bf16, b = torch.bfloat16, 64
    depth = VIT_H["visual_enc_depth"] + VIT_H["text_enc_depth"]
    counters = {"mega": mega.attention_block, "kff": ffb.ff_block,
                "core_fwd": mega.mega_core_fwd,
                "core_bwd": mega.mega_core_bwd,
                "k2_fwd": mega.attention_block_fwd_stored,
                "k2_bwd": mega.attention_block_bwd,
                "k1_fwd": ffb.ff_block_fwd_stored,
                "k1_p1": ffb.ff_block_bwd_p1, "k1_p2": ffb.ff_block_bwd_p2}
    gen = torch.Generator(device="cuda").manual_seed(27)
    text = texts(gen, b, seq=77, vocab=49408)
    images = rand(gen, b, 3, 224, 224, dtype=bf16)
    t0 = time.perf_counter()
    model = CLIP(**VIT_H, **VIT_H_ROUTES, param_dtype=bf16,
                 compute_dtype="bfloat16", device="cuda", seed=27)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = sum(t.numel() for t in model.parameters())
    width = kernel_width(VIT_H["visual_dim_head"], bf16,
                         VIT_H["visual_heads"])
    if width != VIT_H["visual_dim_head"]:
        fail(f"ViT-H vision heads of 80 run at {width}")
    print(f"  ViT-H/14 widths: {params:,} parameters (built in {init_s:.1f} "
          f"s); depths {VIT_H['visual_enc_depth']} + "
          f"{VIT_H['text_enc_depth']}; FF the repo's GEGLU at 4x (inner "
          f"5,120 / 4,096), not OpenCLIP's GELU MLP; vision heads of 80 at "
          f"their true width: the megablock's qkv product "
          f"{3 * VIT_H['visual_heads'] * width:,} columns, its out product "
          f"{VIT_H['visual_heads'] * width:,} rows", flush=True)
    widths, pads = collections.Counter(), []
    with contextlib.ExitStack() as spies, \
            warnings.catch_warnings(record=True) as caught:
        for spy in width_spies(widths, pads):
            spies.enter_context(spy)
        warnings.simplefilter("always")
        with torch.no_grad():
            model(text, images, return_latents=True)
            reps = 3
            torch.cuda.synchronize()
            zero_counts(counters)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                latents = model(text, images, return_latents=True)
            end.record()
            torch.cuda.synchronize()
        served = read_counts(counters)
        serve_ms = start.elapsed_time(end) / reps
        want = {k: 0 for k in counters}
        want.update(mega=reps * depth, kff=reps * depth,
                    core_fwd=reps * depth)
        if served != want:
            fail(f"ViT-H serving launches {served}, expected {want}")
        if not all(t.shape == (b, VIT_H["dim_latent"])
                   and torch.isfinite(t).all() for t in latents):
            fail("ViT-H latents are not finite (b, 1024)")
        plain = CLIP(**VIT_H, **PLAIN_ROUTES, param_dtype=bf16,
                     compute_dtype="bfloat16", device="cuda")
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            worst = max((x - y).abs().max().item() for x, y in zip(
                model(text[:4], images[:4], return_latents=True),
                plain(text[:4], images[:4], return_latents=True)))
        del plain
        torch.cuda.empty_cache()
        tol = LATENT_TOL[bf16]
        if not worst <= tol:
            fail(f"ViT-H latents differ from the plain routes' by "
                 f"{worst:.3e} > {tol:.0e}")
        step = make_train_step(model, default_optimizer(model.parameters(),
                                                        learning_rate=1e-4))

        def run(i):
            return step(text, images, generator=torch.Generator(
                device="cuda").manual_seed(270 + i))

        warm, timed = 1, 3
        step_ms, counts, peak, losses = timed_steps(run, warm, timed,
                                                    counters)
    fallbacks = [str(w.message) for w in caught
                 if "falling back to the XLA path" in str(w.message)]
    if fallbacks:
        fail(f"ViT-H: fallback warnings {fallbacks}")
    if pads:
        fail(f"ViT-H: pad_heads ran at dim_head {sorted(set(pads))}")
    if not widths[("mega", "fwd", 80)]:
        fail(f"ViT-H: no megablock launch at heads of 80: {dict(widths)}")
    check_losses("ViT-H train", losses, b)
    per_step = {k: v / (warm + timed) for k, v in counts.items()}
    want = {k: 0 for k in counters}
    want.update(k2_fwd=depth, k2_bwd=depth, core_fwd=depth, core_bwd=depth,
                k1_fwd=depth, k1_p1=depth, k1_p2=depth)
    if per_step != want:
        fail(f"ViT-H training launches per step {per_step}, expected {want}")
    print(f"  ViT-H serving b={b}: {b * 1e3 / serve_ms:.1f} pairs/s "
          f"({serve_ms:.2f} ms a batch), launches over {reps} batches "
          f"{ {k: v for k, v in served.items() if v} }; latents (b=4) vs "
          f"plain routes {worst:.3e} (tol {tol:.0e})", flush=True)
    print(f"  ViT-H training b={b}: {b * 1e3 / step_ms:.1f} pairs/s "
          f"({step_ms:.2f} ms a step), peak memory {peak:.2f} GiB, losses "
          + " ".join(f"{v:.4f}" for v in losses.tolist())
          + f", launches per step { {k: v for k, v in per_step.items() if v} }",
          flush=True)
    del model, step
    torch.cuda.empty_cache()
    phase(27, "vit-h", f"{card}: ViT-H/14-width CLIP (vision 1280, 16 x 80 "
          f"at the true width, 257 tokens; text 1024, 16 x 64, 77 tokens), "
          f"{VIT_H['visual_enc_depth']} + {VIT_H['text_enc_depth']} layers, "
          f"bf16: serving b={b} {b * 1e3 / serve_ms:.1f} pairs/s (K-MEGA and "
          f"K-FF every layer), latents vs plain {worst:.2e}; training b={b} "
          f"{b * 1e3 / step_ms:.1f} pairs/s, peak {peak:.2f} GiB, K2 and K1 "
          f"{depth} a step, losses finite")


def main(argv):
    # an older checkout whose product kernel phase 19 times beside this one's
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = Path(argv[1]).resolve()
    elif argv:
        fail(f"usage: chip_smoke.py [--parent DIR], not {argv}")
    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(0, "device", f"{torch.cuda.get_device_name(0)} | {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.device_count()} device(s)")

    if not (ROOT / "xclip_tpu_torch" / "csrc").is_dir():
        fail(f"no xclip_tpu_torch/csrc beside {Path(__file__).name}: run it "
             "from the root of a checkout of the repository")
    from xclip_tpu_torch import CLIP
    from xclip_tpu_torch import eval as teval
    from xclip_tpu_torch.convert import load_jax_params, numpy_params
    from xclip_tpu_torch.train import default_optimizer, make_train_step
    from xclip_tpu_torch.kernels import _build
    from xclip_tpu_torch.kernels import attention_block as core
    from xclip_tpu_torch.kernels import attention_megablock as mega
    from xclip_tpu_torch.kernels import flash_attention as flash
    from xclip_tpu_torch.kernels import fused_ff as k8
    from xclip_tpu_torch.kernels import fused_ff_block as ffb
    from xclip_tpu_torch.kernels import fused_infonce as lse5
    from xclip_tpu_torch.kernels import rows as rk

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    phase(1, "build", f"nvcc sm_90a, {seconds:.1f} s → {_build.library_path().name}")
    # the older checkout's library (phases 6, 12 and 19 time its kernels
    # beside this checkout's)
    parent_lib = parent and parent_library(parent)

    # ---------------------------------------------------------------- 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    phase(2, "kernels", "kernel vs plain version on the card")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for label, rows in (("text rows 8x257", 8 * 257),
                            ("vision rows 8x64", 8 * 64)):
            args = ff_inputs(gen, rows, dtype)
            errs[("ff", label, dtype)] = compare(
                f"K-FF {tag} {label} x512 -> 2x2048", ffb.ff_block(*args),
                ffb.ff_block_plain(*args), TOL[dtype])
        lengths = [257, 200, 150, 100, 60, 30, 10, 1]      # CLS always valid
        args = mega_inputs(gen, 8, 257, 512, 8, dtype, lengths)
        static = (8, 64, 64 ** -0.5, False, True)
        errs[("mega", "text", dtype)] = compare(
            f"K-MEGA {tag} (8, 257, 512) 8x64 key-pad",
            mega.attention_block(*args, *static),
            mega.attention_block_plain(*args, *static), TOL[dtype])
        args = mega_inputs(gen, 2, 70, 128, 2, dtype, [50, 0])  # dead rows
        static = (2, 64, 0.125, True, True)
        compare(f"K-MEGA {tag} (2, 70, 128) 2x64 causal dead rows",
                mega.attention_block(*args, *static),
                mega.attention_block_plain(*args, *static), TOL[dtype])
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 3
    before = (ffb.ff_block.launches, mega.attention_block.launches)
    worst = golden_outputs_err(CLIP, load_jax_params, numpy_params)
    if (ffb.ff_block.launches == before[0]
            or mega.attention_block.launches == before[1]):
        fail("the golden model did not run through the kernels")
    if not worst <= 1e-4:
        fail(f"port vs JAX golden: max_abs_err {worst:.3e} > 1e-4")
    phase(3, "golden", f"tiny CLIP (fp32, kernel routes) vs JAX outputs: "
          f"max_abs_err {worst:.3e} (tol 1e-4)")

    # ---------------------------------------------------------------- 4
    clip = CLIP(**FLAGSHIP, **KERNEL_ROUTES, param_dtype=torch.bfloat16,
                compute_dtype="bfloat16", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [(texts(gen, 64), rand(gen, 64, 3, 256, 256)) for _ in range(4)]
    class_tokens = texts(gen, 20, seq=256)
    labels = torch.randint(0, 10, (64,), generator=gen, device="cuda")
    torch.cuda.synchronize()

    ffb.ff_block.launches = mega.attention_block.launches = 0
    scores = [clip(t, i) for t, i in batches]
    classifier = teval.build_zero_shot_classifier(clip, class_tokens,
                                                  templates_per_class=2)
    top1 = teval.zero_shot_accuracy(clip, batches[0][1], labels, classifier)
    tl, il = clip(*batches[0], return_latents=True)
    recall = teval.retrieval_metrics(tl, il)
    torch.cuda.synchronize()
    launches = {"ff": ffb.ff_block.launches,
                "mega": mega.attention_block.launches}

    # 4 scored batches + 1 latent batch + the classifier's text encode each
    # run 6 megablocks and 6 text FF blocks; every image encode (4 + 1 + 1
    # for the zero-shot logits) runs 6 vision FF blocks
    want = {"mega": 6 * 6, "ff": 6 * 6 + 6 * 6}
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    logits = teval.zero_shot_logits(clip, batches[0][1], classifier)
    for name, t, shape in [("scores", torch.stack(scores), (4, 64)),
                           ("classifier", classifier, (10, 512)),
                           ("logits", logits, (64, 10)),
                           ("latents", tl, (64, 512))]:
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            fail(f"{name}: shape {tuple(t.shape)} (want {shape}) or not finite")
    counts = []
    for fn in (lambda: clip.model.encode_text(batches[0][0]),
               lambda: clip.model.encode_image(batches[0][1])):
        f0, m0 = ffb.ff_block.launches, mega.attention_block.launches
        fn()
        counts.append((mega.attention_block.launches - m0,
                       ffb.ff_block.launches - f0))
    if counts != [(6, 6), (0, 6)]:
        fail(f"(mega, ff) launches per text / image encode: {counts}")

    def routes_agree(dtype, model, b):
        plain = CLIP(**FLAGSHIP, **PLAIN_ROUTES, device="cuda",
                     param_dtype=model.temperature.dtype,
                     compute_dtype=model.model.compute_dtype)
        plain.load_state_dict(model.state_dict())
        t, i = batches[1][0][:b], batches[1][1][:b]
        worst = 0.0
        for k, p in zip(model(t, i, return_latents=True),
                        plain(t, i, return_latents=True)):
            worst = max(worst, (k - p).abs().max().item())
        tag = str(dtype).split(".")[-1]
        if not worst <= LATENT_TOL[dtype]:
            fail(f"{tag} kernel routes vs plain routes: latents differ by "
                 f"{worst:.3e} > {LATENT_TOL[dtype]:.0e}")
        return f"{tag} latents vs plain routes {worst:.3e} (tol {LATENT_TOL[dtype]:.0e})"

    agree = [routes_agree(torch.bfloat16, clip, 64)]
    clip32 = CLIP(**FLAGSHIP, **KERNEL_ROUTES, device="cuda", seed=0)
    agree.append(routes_agree(torch.float32, clip32, 8))
    del clip32
    phase(4, "main", f"4x64 pairs scored, zero-shot top1 {top1['top1']:.3f}, "
          f"t2i r@1 {recall['t2i_r@1']:.3f}; launches {launches}; "
          + "; ".join(agree))

    # ---------------------------------------------------------------- 5
    b = 256
    big_text, big_images = texts(gen, b), rand(gen, b, 3, 256, 256)
    plain = CLIP(**FLAGSHIP, **PLAIN_ROUTES, param_dtype=torch.bfloat16,
                 compute_dtype="bfloat16", device="cuda")
    plain.load_state_dict(clip.state_dict())
    ms = {}
    for route, model in (("plain", plain), ("kernel", clip),
                         ("kernel2", clip), ("plain2", plain)):
        ms[route] = cuda_ms(lambda: model(big_text, big_images), reps=3,
                            iters=2)
    kernel_ms = min(ms["kernel"], ms["kernel2"])
    plain_ms = min(ms["plain"], ms["plain2"])
    phase(5, "times", f"{card}: inference b={b} bf16: kernel routes "
          f"{b / kernel_ms * 1e3:.1f} pairs/s ({ms['kernel']:.2f}, "
          f"{ms['kernel2']:.2f} ms), plain routes {b / plain_ms * 1e3:.1f} "
          f"pairs/s ({ms['plain']:.2f}, {ms['plain2']:.2f} ms)")

    dt = torch.bfloat16
    times = {}
    for label, rows in (("text", b * 257), ("vision", b * 64)):
        args = ff_inputs(gen, rows, dt)
        times[("ff", label)] = (cuda_ms(lambda: ffb.ff_block(*args)),
                                cuda_ms(lambda: ffb.ff_block_plain(*args)))
        print(f"  K-FF bf16 ({rows}, 512) -> 2x2048: kernel "
              f"{times[('ff', label)][0]:.3f} ms, plain "
              f"{times[('ff', label)][1]:.3f} ms", flush=True)
    mega_lengths = torch.randint(1, 258, (b,), generator=gen,
                                 device="cuda").tolist()
    args = mega_inputs(gen, b, 257, 512, 8, dt, mega_lengths)
    static = (8, 64, 64 ** -0.5, False, True)
    times[("mega", "text")] = (
        cuda_ms(lambda: mega.attention_block(*args, *static)),
        cuda_ms(lambda: mega.attention_block_plain(*args, *static)))
    print(f"  K-MEGA bf16 ({b}, 257, 512) 8x64: kernel "
          f"{times[('mega', 'text')][0]:.3f} ms, plain "
          f"{times[('mega', 'text')][1]:.3f} ms", flush=True)
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 6
    train_errs, train_ms, train_costs = train_kernels(gen, ffb, mega)
    # the text tower's key pads: chip_smoke.texts' caption lengths and CLS
    lgen = torch.Generator().manual_seed(6)
    core_lengths = (torch.randint(4, 257, (256,), generator=lgen) + 1).tolist()
    core_errs, core_ms, core_costs, core_library = mega_core_kernels(
        mega, "text key-pad", 256, 257, core_lengths, True, seed=6)
    # full-length captions: the fifth key tile (one key) is walked too
    mega_core_kernels(mega, "text full-length", 256, 257, [257] * 256, True,
                      seed=7)
    # the fp32 FMA core: at the text tower's shape, and at one SimSiam pass
    # of phase 23 (256 fp32 views of 32 kept patches and CLS, no pads)
    f32_core = {shape: mega_core_kernels(
        mega, label, 256, n, lengths, dead, seed=seed, dt=torch.float32,
        parent=parent_lib)
        for shape, label, n, lengths, dead, seed in (
            ("text", "text key-pad", 257, core_lengths, True, 6),
            ("ssl", "SimSiam pass", 33, [33] * 256, False, 23))}
    # long lengths, up to the mask words' 2048
    f32_long_core(core, mega)

    # ---------------------------------------------------------------- 7
    train_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
                 make_train_step)

    # ---------------------------------------------------------------- 8
    del clip, plain
    row_counters = {f"rows_{k}_{m}": (k, m)
                    for k, m in (*rk.COUNTERS, *rk.LN_FWD_COUNTERS)}
    train_launches, stored = train_flagship(card, CLIP, default_optimizer,
                                            make_train_step, ffb, mega,
                                            row_counters)

    # ---------------------------------------------------------------- 9
    lean_errs, lean_ms, lean_costs = lean_kernels(gen, ffb, mega, lse5)
    mega_core_kernels(mega, "vision", 256, 32, [32] * 256, False, seed=9)

    # --------------------------------------------------------------- 10
    lean_counters = {"k3_fwd": mega.attention_block_fwd_stats,
                     "k3_bwd": mega.attention_block_bwd_recompute,
                     "kffs": ffb.ff_block_fwd_stats,
                     "ff_rc": ffb.ff_block_bwd_recompute,
                     "k5_fwd": lse5.streaming_lse_fwd,
                     "k5_bwd": lse5.streaming_lse_bwd,
                     "core_fwd": mega.mega_core_fwd,
                     "core_bwd": mega.mega_core_bwd,
                     "rows_geglu_recompute":
                         row_counters["rows_geglu_recompute"],
                     "rows_ln_ln": row_counters["rows_ln_ln"],
                     **{k: row_counters[k] for k in (
                         "rows_ln_fwd_plain", "rows_ln_fwd_stats",
                         "rows_ln_fwd_residual")},
                     **SUM_SITES}
    before = read_counts(lean_counters)
    train_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
                 make_train_step, number=10, prefix="lean_")
    after = read_counts(lean_counters)
    # the ordered sums' sites are the flagship's widths, not the tiny CLIP's
    missed = [k for k in lean_counters
              if k not in SUM_SITES and after[k] == before[k]]
    if missed:
        fail(f"the lean golden step did not run through {missed}")

    # --------------------------------------------------------------- 11
    lean_launches, product_launches, lean2048 = lean_train(
        card, CLIP, default_optimizer, make_train_step, lean_counters, stored,
        expected_products(ffb, mega),
        lambda b: {**expected_rows(ffb, mega, b),
                   **expected_ln_fwd(ffb, mega, b),
                   **expected_sums(ffb, mega, b)})
    dt = torch.bfloat16
    for tower, n in (("text", 257), ("vision", 32)):
        rows = 2048 * n
        print(f"  b=2048 {tower} ({rows} rows) chunks per call: K-FF-s "
              f"{len(ffb.fwd_stats_spans(rows, 512, 2048, dt))}, FF recompute "
              f"backward {len(ffb.bwd_recompute_spans(rows, 512, 2048, dt))}"
              f", K3 forward "
              f"{len(mega.fwd_stats_spans(2048, n, 512, 8, dt, False))}, K3 "
              f"backward "
              f"{len(mega.bwd_recompute_spans(2048, n, 512, 8, dt, False))}",
              flush=True)

    # --------------------------------------------------------------- 12
    attn_errs, attn_ms, attn_costs, attn_library = attn_kernels(
        gen, core, flash, parent_lib)

    # --------------------------------------------------------------- 13
    rotary_counters = {"k6_fwd": core.attention_core_fwd,
                       "k6_bwd": core.attention_core_bwd,
                       "k7_fwd": flash.flash_attention_fwd,
                       "k7_bwd": flash.flash_attention_bwd}
    f32_attn_launches = rotary_golden(
        CLIP, load_jax_params, numpy_params, default_optimizer,
        make_train_step, rotary_counters)

    # --------------------------------------------------------------- 14
    rotary_serve(card, CLIP, {**rotary_counters, "kff": ffb.ff_block})

    # --------------------------------------------------------------- 15
    rotary_launches = rotary_train(
        card, CLIP, default_optimizer, make_train_step,
        {**rotary_counters, "k1_fwd": ffb.ff_block_fwd_stored,
         "k1_p1": ffb.ff_block_bwd_p1, "k1_p2": ffb.ff_block_bwd_p2,
         "rows_ln_geglu": row_counters["rows_ln_geglu"],
         "rows_ln_ln": row_counters["rows_ln_ln"]})

    # --------------------------------------------------------------- 16
    ff_errs, ff_ms, ff_costs, ff_peaks = ff_kernels(gen, ffb, k8)

    # --------------------------------------------------------------- 17
    ff_counters = {"k8_fwd": k8.geglu_layernorm_fwd,
                   "k8_bwd": k8.geglu_layernorm_bwd,
                   "k1h_fwd": ffb.ff_block_fwd_stored_h,
                   "k1h_p1": ffb.ff_block_bwd_p1_stored_h,
                   "k1h_p2": ffb.ff_block_bwd_p2}
    ff_golden(CLIP, load_jax_params, numpy_params, default_optimizer,
              make_train_step, ff_counters)

    # --------------------------------------------------------------- 18
    ff_launches = ff_routes(
        card, CLIP, default_optimizer, make_train_step,
        {**ff_counters, "k1_fwd": ffb.ff_block_fwd_stored,
         "kff": ffb.ff_block, "mega": mega.attention_block,
         "k2_fwd": mega.attention_block_fwd_stored,
         "k2_bwd": mega.attention_block_bwd,
         **{k: c for k, c in row_counters.items()
            if not k.startswith("rows_ln_fwd") or k == "rows_ln_fwd_geglu"}},
        stored)

    # --------------------------------------------------------------- 19
    # the rows of one chunk at each product call site of the b = 2048
    # step's text tower
    dt = torch.bfloat16
    first = {"ff_fwd": ffb.fwd_stats_spans(2048 * 257, 512, 2048, dt)[0],
             "ff_bwd": ffb.bwd_recompute_spans(2048 * 257, 512, 2048, dt)[0],
             "mega_fwd": mega.fwd_stats_spans(2048, 257, 512, 8, dt,
                                              False)[0],
             "mega_bwd": mega.bwd_recompute_spans(2048, 257, 512, 8, dt,
                                                  False)[0]}
    step_rows = {site: (stop - start) * (257 if site.startswith("mega")
                                         else 1)
                 for site, (start, stop) in first.items()}
    mm_errs, mm_ms, mm_costs, mm_library = products(gen, step_rows)
    f32_mm = f32_products(gen, parent_lib)

    # --------------------------------------------------------------- 20
    row_errs, row_ms, row_costs, row_library = rows_phase(gen, step_rows)
    fwd_errs, fwd_ms, fwd_costs, fwd_library = ln_fwd_phase(gen)
    sum_errs, sum_ms, sum_costs, sum_library = reduce_phase(gen, step_rows)

    # --------------------------------------------------------------- 21
    wide, wide_launches, true_width, width_launches = narrow_heads(
        card, CLIP, default_optimizer, make_train_step, {
        "mega": mega.attention_block, "kff": ffb.ff_block,
        "k2_fwd": mega.attention_block_fwd_stored,
        "k2_bwd": mega.attention_block_bwd,
        "k1_fwd": ffb.ff_block_fwd_stored, "k1_p1": ffb.ff_block_bwd_p1,
        "k1_p2": ffb.ff_block_bwd_p2, "kffs": ffb.ff_block_fwd_stats,
        "ff_rc": ffb.ff_block_bwd_recompute,
        "k6_fwd": core.attention_core_fwd, "k6_bwd": core.attention_core_bwd,
        "k7_fwd": flash.flash_attention_fwd,
        "k7_bwd": flash.flash_attention_bwd})

    # --------------------------------------------------------------- 22
    train_surface(card, CLIP, default_optimizer, make_train_step, ffb, mega,
                  lse5, lean2048)

    # --------------------------------------------------------------- 23
    f32_step = objectives(card, CLIP, default_optimizer, make_train_step,
                          ffb, mega, lse5, load_jax_params, numpy_params)

    # --------------------------------------------------------------- 24
    shard = data_parallel(card, CLIP, default_optimizer, make_train_step,
                          lse5)

    # --------------------------------------------------------------- 25
    data_pipeline(card, CLIP, default_optimizer, make_train_step, ffb, mega)

    # --------------------------------------------------------------- 26
    tensor_parallel(card, CLIP, default_optimizer, make_train_step, ffb,
                    mega, stored)

    # --------------------------------------------------------------- 27
    vit_h(card, CLIP, default_optimizer, make_train_step, ffb, mega, parent)

    # --------------------------------------------------------------- 28
    examples_phase(card, ffb, mega, lse5)

    def entry(name, source, replaces, launches, err, kms, cost, peak,
              library_ms=None):
        b_ms, b_by = bound(*cost, peak)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": kms[0], "plain_ms": kms[1],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}

    # no single PyTorch call computes the blocks' functions, nor K8's or
    # K1-h's (library_ms null); the megablock's core, K6 and K7 against
    # scaled_dot_product_attention on the same q, k, v and mask, forward or
    # backward
    rows = b * 257
    record = {"kernels": [
        entry("K-FF ff_block forward",
              "xclip_tpu_torch/csrc/fused_ff_block.cu",
              "xclip_tpu/kernels/fused_ff_block.py:143", launches["ff"],
              errs[("ff", "text rows 8x257", torch.bfloat16)],
              times[("ff", "text")], ff_cost("fwd", rows), BF16_PEAK),
        entry("K-MEGA attention_block forward",
              "xclip_tpu_torch/csrc/attention_megablock.cu",
              "xclip_tpu/kernels/attention_megablock.py:278",
              launches["mega"], errs[("mega", "text", torch.bfloat16)],
              times[("mega", "text")],
              mega_cost("fwd", b, 257, mega_lengths), BF16_PEAK),
    ]}
    for key, name, source, replaces in TRAIN_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, train_launches[key], train_errs[key],
            train_ms[key], train_costs[key], BF16_PEAK))
    for key, name, source, replaces in LEAN_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, lean_launches[key], lean_errs[key],
            lean_ms[key], lean_costs[key],
            FP32_PEAK if key.startswith("k5") else BF16_PEAK))
    for key, name, source, replaces in CORE_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, lean_launches[key], core_errs[key],
            core_ms[key], core_costs[key], BF16_PEAK, core_library[key]))
    for key, name, source, replaces in ATTN_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, rotary_launches[key], attn_errs[key],
            attn_ms[key], attn_costs[key], BF16_PEAK, attn_library[key]))
    for key, name, source, replaces in FF_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, ff_launches[key], ff_errs[key],
            ff_ms[key], ff_costs[key], ff_peaks[key]))
    # the product kernel by class: launches from phase 11's b = 2048 step,
    # times at 65,792 rows (phase 19), beside torch.mm / addmm
    for key, title, epilogues, ta, tb, calls, replaces in PRODUCT_CLASSES:
        record["kernels"].append(entry(
            f"bf16 product kernel: {title} ({calls[0][0]}, 65,792 rows)",
            "xclip_tpu_torch/csrc/gemm_sm90.cu", replaces,
            sum(product_launches[(epi, ta, tb)] for epi in epilogues),
            mm_errs[key], mm_ms[key], mm_costs[key], BF16_PEAK,
            mm_library[key]))
    # the fp32 product kernel by class: launches from phase 23's stored
    # step (7 steps; the SimSiam passes' fp32 views, counted in the
    # library), times at phase 19's fp32 rows beside torch.mm / addmm in
    # fp32
    f32_errs, f32_ms, f32_costs, f32_library, _ = f32_mm
    for key, title, epilogues, ta, tb, calls, replaces in PRODUCT_CLASSES:
        for rows in F32_ROWS:
            record["kernels"].append(entry(
                f"fp32 product kernel: {title} ({calls[0][0]}, {rows:,} "
                f"rows)", "xclip_tpu_torch/csrc/gemm_f32.cu", replaces,
                sum(f32_step["products"][(epi, ta, tb)]
                    for epi in epilogues),
                f32_errs[key, rows], f32_ms[key, rows], f32_costs[key, rows],
                FP32_PEAK, f32_library[key, rows]))
    # the fp32 attention kernels: the megablock's FMA core (launches in
    # phase 23's profiled stored step, by kernel name), K6's and K7's fp32
    # kernels (launches in phase 13's fp32 goldens), beside SDPA in fp32
    for shape, where in (("text", "(256, 257)"), ("ssl", "(256, 33)")):
        c_errs, c_ms, c_costs, c_library = f32_core[shape]
        for key, kernel, name, source, replaces in F32_CORE_KERNELS:
            record["kernels"].append(entry(
                f"{name} {where}", source, replaces,
                f32_step["attention"][kernel][1], c_errs[key], c_ms[key],
                c_costs[key], FP32_PEAK, c_library[key]))
    for key, counter, name, source, replaces in F32_ATTN_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, f32_attn_launches[counter],
            attn_errs[key], attn_ms[key], attn_costs[key], FP32_PEAK,
            attn_library[key]))
    # the row kernels by mode: launches from the run of the route that
    # takes the mode (phases 8, 11, 18), times at phase 20's first shape,
    # the plain LayerNorm backward beside native_layer_norm_backward
    row_launches = {**train_launches, **lean_launches, **ff_launches}
    for key, title, kernel, mode, replaces, shapes in ROW_KERNELS:
        form, rows, d = shapes[0]
        rows = step_rows[form] if rows == "R" else rows
        record["kernels"].append(entry(
            f"{title} ({rows} x {d})", "xclip_tpu_torch/csrc/row_kernels.cuh",
            replaces, row_launches[key], row_errs[key], row_ms[key],
            row_costs[key], FP32_PEAK, row_library[key]))
    # the LayerNorm forward rows by mode: launches from the run of the route
    # that takes the mode (phases 8, 11, 18), times at phase 20's first
    # shape, the plain mode beside F.layer_norm
    for key, title, mode, replaces, shapes in LN_FWD_KERNELS:
        src, rows, d = shapes[0]
        record["kernels"].append(entry(
            f"{title} ({rows} x {d}, {src} in)",
            "xclip_tpu_torch/csrc/row_kernels.cuh", replaces,
            row_launches[f"rows_{key}"], fwd_errs[key], fwd_ms[key],
            fwd_costs[key], FP32_PEAK, fwd_library[key]))
    # the ordered sums at the lean step's call sites: launches from phase
    # 11's b = 2048 run, times at phase 20's shapes, beside part.sum(0)
    for key, name, _, _, _, replaces in SUM_SHAPES[:len(SUM_SITES)]:
        record["kernels"].append(entry(
            name, "xclip_tpu_torch/csrc/common.cuh", replaces,
            lean_launches[key], sum_errs[key], sum_ms[key], sum_costs[key],
            FP32_PEAK, sum_library[key]))
    # K5 at one rank of the 32k batch: launches from phase 24's
    # data-parallel step, times at (2048, 32768, 512) beside
    # logsumexp(x @ y.T)
    shard_launches, shard_errs, shard_ms, shard_costs, shard_library = shard
    for key, name, source, replaces in SHARD_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, shard_launches[key], shard_errs[key],
            shard_ms[key], shard_costs[key], FP32_PEAK, shard_library[key]))
    # the 128-wide kernels: launches from phase 21's case with heads of 128
    # in both towers (its serving and train step), times at phase 21's
    # shapes beside SDPA in the same dtype
    w_errs, w_ms, w_costs, w_library, w_peaks = wide
    for key, case, counter, name, source, replaces in WIDE_KERNELS:
        record["kernels"].append(entry(
            name, source, replaces, wide_launches[case][counter], w_errs[key],
            w_ms[key], w_costs[key], w_peaks[key], w_library[key]))
    # the 192- and 256-wide bf16 kernels: launches at their width from
    # phase 21's case (its serving and train step), times at phase 21's
    # text shapes beside SDPA in bf16
    t_errs, t_ms, t_costs, t_library = true_width
    for key, case, name, source, replaces in TRUE_WIDTH_KERNELS:
        fam, d, kind = key.split("_")
        record["kernels"].append(entry(
            name, source, replaces,
            width_launches[case].get((fam, kind, int(d)), 0), t_errs[key],
            t_ms[key], t_costs[key], BF16_PEAK, t_library[key]))
    # no time under the least the card could take: one below its bound was
    # read from a cache the bound does not count
    for k in record["kernels"]:
        if k["ms"] < k["bound_ms"]:
            fail(f"{k['name']}: {k['ms']:.4f} ms, under its bound "
                 f"{k['bound_ms']:.4f} ms ({k['bound_by']})")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main(sys.argv[1:])
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
