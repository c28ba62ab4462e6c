"""Smoke run of the PyTorch/CUDA port on one Hopper card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card: a CUDA device must exist; prints its name and power limit;
  2. build: compiles every kernel of ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a (one nvcc per source, all at once), prints build seconds
     and the ptxas register / shared-memory lines;
  3. kernels against their plain versions on the card (TF32 off): chunk
     attention at the serving shape (Yi-6B heads 32/4, hd 128, bf16, a
     256-token chunk over 768 prior tokens in a sentinel-padded 64-block
     prior table) and at small edge cases (float32 and bf16, softcap,
     window, ragged C and Sk, padded query rows at -(2**30), n_rep 1 and 8);
     paged decode at B=8, block 16, ragged lengths, dead table entries at 0,
     out-of-order pool ids, split over the context by ``decode_plan`` (9
     splits at the serving shape; its edges: lengths 1 and one block, a
     split boundary and one token either side, a full table, free lanes
     whose tables are all sentinel), and 20 launches giving the same bits.
     bf16 is held at 2e-2 against the plain version
     in float32 on the same bf16 inputs, float32 at 1e-4.  Times: kernel,
     plain version and the library yardstick
     (``F.scaled_dot_product_attention``, timed here only), each launch
     timed with CUDA events after a 64 MiB L2 flush;
  4. the slice at full width: Yi-6B with all 32 layers in bf16, weights from
     a seeded generator, served through ``repro_torch.serve.ServeEngine``
     (8 slots, max_seq 2048, block 16, prefill chunk 256, prefix sharing on)
     on 8 greedy requests of 64-700 prompt tokens, two sharing a 256-token
     prefix, 32 new tokens each.  The kernel launch counts are set to 0 just
     before and read just after, and must equal 32 per decode step and 32
     per prefill chunk;
  5. the card against the CPU: a reduced Yi-6B (4 layers, float32) with
     identical weights serves the same greedy trace on the card (kernels)
     and on the CPU (plain versions): identical tokens, first logits within
     1e-4;
  6. the training slice: Yi-6B widths at 8 of its 32 layers in bf16 with
     per-layer remat, weights from a seeded generator, trained 12 steps
     through ``repro_torch.train.StepEngine.for_lm`` (sgd with momentum 0.9,
     micro batch 2, sequences of 2048 tokens from ``TokenStream``,
     ``attn_impl="pallas"``) under a tick-fired DiveBatch program (m0 4,
     m_max 16, granule 2, a tick every 4 steps).  Every loss must be
     finite, and the launch counts, set to 0 just before and read just
     after, must be exactly 16 chunk-attention (forward, and again under
     remat), 8 flash-dq and 8 flash-dk/dv launches per microbatch;
  7. training on the card against the CPU: a reduced float32 Yi-6B widened
     to hd 64, then the reference's own reduced Yi-6B (hd 16), each with
     identical weights, trains 6 steps with a DiveBatch program (a tick
     every 2 steps) on the card (kernels) and on the CPU (plain versions):
     losses within 1e-4 relative, parameters within 1e-4 absolute, the same
     batch schedule and num_micro buckets;
  8. the gram tier: phase 6's model and cut (``attn_impl="pallas"``) trained
     8 steps through a hand-built tiered ``StepEngine`` (``estimator=
     "gram"``, probes from ``repro_torch.models.probes``) under a DiveBatch
     program reading the gram signals (m0 4, m_max 8, delta 2, a tick every
     4 steps), which must resize once.  Launches per microbatch exactly 16
     chunk, 8 dq, 8 dk/dv, 2 psgn_fused (the q/o and the k/v groups), 24
     psgn_gram (gate, up, down) and no psgn_direct, every psgn launch on
     the tensor-core route.  Then one microbatch timed in parts (main pass,
     probe pass, psgn kernels), and ``probes.persample_sq_norms_gram`` on
     it (timed, with its peak memory): 32 psgn_direct and 24 psgn_gram
     launches, all on the split route (its deltas are float32), with 56
     psgn_split launches (each delta split once) and no FMA launch, its
     (B,) result within 1e-4 relative of the tree's (the routes against
     each other, on the card);
  9. the gram tier on the card against the CPU: a reduced float32 Yi-6B (hd
     64, d_ff 1024, S 128, where every layer takes the dispatch Yi-6B takes
     at S 2048) trains 5 steps (a tick every 2): losses, Delta at the ticks
     and ``sq_norm_sum`` within 1e-4 relative, parameters within 1e-4, one
     batch schedule; every psgn_fused and psgn_gram launch on the split
     route (x and delta split once each).

The chunk forward, dq and dk/dv have two routes each, chosen per kernel by
``kattn.attention_plan``: in bf16 the forward, dq and dk/dv take the
tensor-core kernels (``chunk_attention_tc.cu``, ``flash_dq_tc.cu``,
``flash_dkv_tc.cu``) at hd 64, 80, 112 and 128 causal or not (the forward
up to 65536 keys); float32, hd 16 and 32, and a forward over more keys the
FMA kernels.  Phase 3 holds both against the plain versions and prints each
case's routes in brackets (``[tc]``, ``[fma]``; ``[dq tc, dk/dv tc]`` for
the backward),
with the key tiles the tensor-core forward visited out of all, as its
blocks counted them on the card (it skips tiles by position); its
tensor-core cases add ragged C and S, C < 64, n_rep 1, 4 and
8, hd 64 and 128, softcap, a window across tiles, padded rows, a live row
with no attendable key, a sentinel-only prior tail,
shuffled keys at positions past the array bounds, 128-row blocks, the
serving shape and the training shape; the backward's add S 1, 63, 64, 65,
129 and 300 at hd 64 and 128 with n_rep 1, 2 and 8, a window across tiles
and softcap 20, causal cases at hd 80 and 112, and a bf16 forward over
65537 keys (one past the tensor-core kernel's tile list: the FMA route).
Every phase asserts that each chunk, dq and dk/dv launch took the route the
plan names for its kernel at the phase's type, head dim and causality:
phases 4, 6, 8, 12 and 14 (bf16, hubert's non-causal hd 80) the tensor
cores for all three, phases 5, 7, 9 and 15 (float32) the FMA kernels.

Phase 3 also holds the non-causal chunk forward, dq and dk/dv against their
plain versions: float32 (1e-4) and bf16 (2e-2 forward, the backward at
2e-3 absolute as above) at hd 16, 32, 64, 80, 112 and 128, each without a
window and with a one-sided one, n_rep 1 and 4, softcaps, ragged S, and a
prefill chunk with sentinel keys and padded rows; every launch on its
kernel's planned route.  Then the three at hubert-xlarge's training shape
(B 2, S 1024, 16 heads of hd 80, non-causal, bf16), the three records
``... (non-causal, hd 80)``: all three on the tensor cores, each timed
beside the plain version and SDPA (``is_causal=False``: the forward, and
its backward for dq and dk/dv) and beside the FMA kernel at the same call,
launched directly (``fma_ms``, ``fma_device_ms``, ``fma_max_abs_err``: the
kernels the tensor-core routes replaced), with the bound at 989 TFLOP/s
(the record's) and at the float32 FMA rate (``fma_bound_ms``).

Phase 3 also holds the flash-attention backward kernels (dq, dk/dv) against
their plain version: float32 edge cases (ragged S 37 and 300, n_rep 1 and
8, softcap, window, a single tile) at 1e-4, the same in bf16, and the
training shape (B 2, S 2048, Yi-6B heads, bf16), timed beside the plain
version and the backward of ``F.scaled_dot_product_attention``.  Their
outputs are float32 from bf16 inputs, rounded at the same points as the
plain version, so the bf16 cases are held at 2e-3 absolute (no relative
term), a tenth of a typical dq at S 2048; each case prints the RMS of the
plain dq, dk and dv beside its error.

Phase 3 also holds the per-sample gradient-norm kernels (psgn direct, gram
and fused over 3 layers) against their plain versions: float32, bf16 and
bf16 activations with float32 deltas, ragged S and widths, a single
position, tile edges (the FMA route), bf16 at widths that are multiples of
8 (the tensor-core route, S up to 2049, widths up to 4104), and the same
widths with a float32 operand, bf16 x f32, f32 x bf16 and f32 x f32 (the
split route); it counts the HGMMA instructions in the
tensor-core libraries' SASS (``cuobjdump``).  Then the gram tier's slice
shapes (B 2, S 2048, bf16): fused over the 16 q/o layers (the record; the
layer table must give the stack's bits) and the 16 k/v layers, gram at
4096 -> 11008 (tensor cores), direct at q with float32 deltas as the
standalone entry point calls it (the split route, bound by the function's
one product at the bf16 rate, the floor of its 3 products beside it; its
peak memory) and the split of those deltas alone
(bit for bit against its plain version), direct at q in f32 x f32 (6
products) and gram at 4096 -> 11008 with float32 deltas (the standalone
entry point's form) and in float32 (the split route, 6 term pairs for each
float32 operand's Gram, also held against the split's plain version, and
the FMA kernel timed beside it at the same call), timed beside the plain
version and a cuBLAS yardstick, each with its route and achieved TFLOP/s.  Products of bf16 values are exact in float32, so every psgn case
is held at 1e-4 relative, and prints the plain values beside its error.
The chunk forward is also timed at the training shape (B 2, S 2048)
beside the forward of ``F.scaled_dot_product_attention``, with its bound.

Phase 3 also holds the int8 quantisation kernel against its plain version,
codes and scales BIT FOR BIT, float32 and bf16: rows not a multiple of a
block, C of 1 and ragged, a long row, an all-zero row, exact .5 ties,
negative-max rows, rows holding a NaN or an infinity (NaN in the same
rows), the pod slice's MLP leaves, the one-pass design's longest row
(32768) and one either side, views at an offset (1 and 8 elements) in both
designs, ragged rows over the two-pass design; then Yi-6B-width leaves, per
tensor (1, 4096 x 11008) float32 (the record: the compressor views a leaf
as one row), rowwise (11008, 4096) in float32 and bf16, and the pod
slice's largest leaf, each with its design, timed beside the plain version
and a library yardstick (amax, divide, round, clamp, cast); bound = bytes
/ 3.35 TB/s, and the two-read floor beside it where a row outgrows the 50
MB L2.

 10. the pod slice: the paper's ``Trainer`` on ``PodLadder(pods=2,
     granule=16)`` over eight virtual devices on the card, the MLP (512 ->
     64 -> 1) on ``sigmoid_synthetic(n=20000, d=512)``, sgd with momentum
     0.9 (lr 0.1), DiveBatch on the moment tier (m0 64 on rung 2, m_max
     128, delta 0.1: Delta is near 1 at the first boundary, so the run moves
     to batch 128 on the cross-pod rung 3); 3 epochs, then pod 1 is marked
     lost, ``demote`` moves the run 3 -> 2, and one more epoch.  The launch
     counts, set to 0 before and read after, must be exactly 2 pods x 4
     leaves ``quantize_int8`` launches per cross-pod step and nothing else;
     prints per epoch the batch, rung, losses and ms per step, the wire
     bytes per exchange and the peak memory;
 11. the pod slice on the card against the CPU: the same run for 2 epochs
     on ``[cuda:0] * 8`` and ``[cpu] * 8`` from identical weights: the same
     (batch, rung, steps) schedule, losses within 1e-3 relative,
     parameters within 1e-2; the codes that differ at the last exchange
     are counted and printed (the runs have drifted apart by then), and at
     one exchange from the same state and batch on both devices at most 8
     of the 65794 codes may differ, and the others' residuals by at most
     1e-3 quanta;
 12. checkpoint and resume on the card (``repro_torch.ckpt``, the
     reference's format), checkpoints in a temporary directory under
     ``build/`` removed afterwards: (a) phase 6's model at 4 of 32 layers
     (``CKPT_LAYERS``: the script's time limit) trains 8 steps through
     ``train_lm.train`` with a checkpoint at each tick (steps 4 and 8;
     bytes, volumes, device -> host and write seconds and GB/s); a fresh
     state with other weights restored from the step-4 checkpoint
     (``train_lm.resume``) runs steps 5-8: the batch schedule and the
     losses must be the uninterrupted run's to the bit, and the launches
     8 chunk, 4 dq and 4 dk/dv per microbatch; (b) phase 10's ``Trainer``
     with ``ckpt_every=1`` runs 2 epochs (rung 3), a fresh ``Trainer`` on a
     fresh ladder ``resume``s onto rung 3 and runs epoch 3: the same
     (batch, rung, steps) as phase 10's epoch 3, losses and parameters
     within phase 11's tolerances (the compression residuals restart at
     zero: they are never checkpointed), 8 ``quantize_int8`` launches per
     cross-pod step; (c) the paper's ResNet-20 (GroupNorm, width 16) on
     ``imagelike_classification(n=50000, hw=32)`` under
     ``launch/train.py``'s DiveBatch defaults on the exact tier, 3 epochs
     with a checkpoint each (per epoch: batch, steps, ms per step,
     images/s, val accuracy, Delta, peak memory and the exact tier's share
     of a step); a fresh ``Trainer`` resumed from the epoch-2 checkpoint
     must repeat epoch 3 to the bit (cuDNN's deterministic algorithms);
     this path launches no hand-written kernel;
 13. ``launch/train.py``'s imagelike task (ResNet depth 8, width 8, hw 16,
     n 6000) on the card and on the CPU with cuDNN and matmul TF32 off
     (cuDNN's deterministic algorithms), 2 epochs from identical weights: one schedule, losses and Delta within
     1e-4 relative, parameters within 1e-4; then the card's checkpoint
     resumes on the CPU and the CPU's on the card, each continuing one
     epoch to the same schedule.  The same 2 epochs run once more on the CPU
     with every float32 the port asks for made float64 (parameters and data
     cast up, ``float32_as_float64``): each side's gap to that run says
     which side carries the card-against-CPU gap (ROADMAP Queue C 1).

 14. hubert-xlarge (the encoder: 48 layers, d_model 1280, 16 heads of hd
     80, non-causal, an embedding frontend, layer norm, GELU MLP, vocab
     504) in bf16 with per-layer remat and ``attn_impl="pallas"``, weights
     from a seeded generator (0.946 B parameters), on sequences of 1024
     frames (frame embeddings N(0, 1) and uniform targets from
     ``default_rng((seed, step))``): (a) ``transformer.prefill_step`` on 4
     sequences, finite (4, 1024, 504) float32 logits and exactly 48
     chunk-forward launches (tensor cores) and nothing else, ms and peak
     memory, then the same frames through the plain dense attention lane
     (``attn_impl="dense"``, no kernel), the largest logit gap within 5e-2
     of the largest logit (``DENSE_GAP_TOL``); (b) 12 moment-tier steps
     through ``StepEngine.for_lm`` (sgd with momentum 0.9, lr 0.02, micro
     batch 2) under phase 6's DiveBatch program, exactly 96 chunk, 48 dq and
     48 dk/dv launches per microbatch, all three on the tensor cores, step
     ms by batch, frames/s, the
     model-FLOP share and peak memory; (c) the gram tier at 12 of the 48 layers (a depth
     cut), 8 steps under phase 8's program with a resize, the psgn
     launches exactly those of ``ops.group_layers``' grouping (all on the
     tensor cores), and one microbatch in parts;
 15. the encoder on the card against the CPU: a hubert-shaped float32
     model (2 layers, d_model 320, 4 heads of hd 80, d_ff 640), then the
     reference's own reduced hubert-xlarge (hd 16, on the FMA kernels), each
     with identical weights: ``prefill_step`` logits within 1e-4, 6
     DiveBatch steps (a tick every 2) with losses within 1e-4 relative,
     parameters within 1e-4 and one batch schedule and bucket list.
 16. scale-out over process groups: ranks spawned from this script
     (``multiprocessing``'s spawn context) after phase 2's build, which they
     load and do not build again, meeting through a ``FileStore`` under
     ``build/``; each line names its backend, world and rank.  (a) NCCL at
     a world of one: phase 15's hubert-shaped float32 encoder, 4 DiveBatch
     steps under a rank plan (``train_lm.train(plan=...)``, every
     microbatch's gradient all-reduced) equal to the run without a plan,
     losses and parameters to the bit; (b) gloo at a world of two on the
     one card: the same encoder data-parallel against one process (losses
     within 1e-5 relative, parameters within 1e-5), then hubert-xlarge at
     full width **cut to 24 of 48 layers** (all 48 before phase 33 joined;
     bf16) through ``for_lm(dp_size=2)``, 2
     sequences of 1024 frames per rank in each microbatch, global batch 8
     then 16 under a DiveBatch program (a tick every 2 steps, delta 16), 4
     steps: finite losses, equal parameter checksums on both ranks at every
     step, exactly 48 chunk, 24 dq and 24 dk/dv launches per microbatch on
     each rank, all on the tensor cores; step ms by batch, all-reduce ms and
     bytes a step, peak memory per rank; (c) phase 10's cell with each pod
     a rank (4 virtual devices each) through ``run_supervised(lose_pod=
     [3])``: the (batch, rung, steps) schedule, losses, Delta and
     parameters equal phase 10's to the bit, the demotion 3 -> 2 included
     (pod 1's rank leaves with phase 10's first 3 epochs), 4
     ``quantize_int8`` launches per rank per cross-pod step, the bytes
     gathered.  Multi-rank numbers on one card go through gloo's host
     staging: no yardstick for NCCL across cards.

 17. the dense family at full width, weights from a seeded generator, bf16,
     ``attn_impl="pallas"``, each model freed before the next: (a)
     gemma2-27b at all 46 layers (28.4 B parameters, 52.9 GiB) served
     through ``ServeEngine`` (4 slots, max_seq 8192, block 16, prefill
     chunk 256, a 4 GiB pool) on 6 greedy requests of 32 new tokens: two
     prompts of about 5000 tokens (padded to 8192, so the 4096-key rings
     wrap and the window cuts keys in the chunk kernel), three of 64-700,
     and an exact repeat of a long one (a full-prompt hit adopting its 512
     blocks and replaying its rings); exactly 23 paged decode launches per
     decode step (the global layers; the sliding-window layers decode
     their rings on the plain lane, as the reference does in XLA) and 46
     chunk launches per prefill chunk; the peak memory beside its
     reckoning (weights, pool, 0.72 GiB of rings per slot, prefill row and
     cached prompt row); (b) qwen2-7b at all 28 layers (n_rep 7) and
     llama3-405b at full width **cut to 4 of its 126 layers** (810 GB at
     full depth; 17 B parameters, n_rep 16, n_rep * hd 2048), each served
     on phase 4's trace with phase 4's engine, one chunk launch per layer
     per prefill chunk and one paged decode per layer per decode step;
     (c) internvl2-1b at all 24 layers: ``prefill_step`` on 4 x 1024
     embeddings (24 chunk launches), 16 lockstep ``decode_step``s on its
     dense cache with (4, 1, 896) embeddings (no launch), finite logits,
     the prompt's logits against the dense lane within ``DENSE_GAP_TOL``;
     (d) gemma2-27b widths **cut to 4 of 46 layers** (memory: weights,
     momenta, gradients and the float32 accumulators of 46 layers are
     ~400 GB) trained at S 8192 (its context; the window cuts the local
     layers), micro batch 1, remat, sgd with momentum 0.9, a tick-fired
     DiveBatch program, 6 steps: finite losses, exactly 8 chunk, 4 dq and
     4 dk/dv launches per microbatch, all on the tensor cores;
 18. the reference's own reduced dense configs (hd 16, float32, the FMA
     kernels) on the card against the CPU: qwen2-7b, llama3-405b and
     gemma2-27b (window 8: the rings wrap within a few tokens) each serve
     one greedy trace with a full-prompt hit, tokens identical and the
     first logits within 1e-4, launches one chunk per layer per prefill
     chunk and one paged decode per global layer per decode step;
     internvl2-1b runs ``prefill_step`` and 8 dense-cache decode steps on
     embeddings, logits within 1e-4 and the same argmax; gemma2 trains 6
     DiveBatch steps as phase 7, losses within 1e-4 relative, parameters
     within 1e-4, one batch schedule;
 19. the MoE family at full width, weights from a seeded generator, bf16,
     ``attn_impl="pallas"``, each model freed before the next (the MoE FFN
     is ``models/moe.py``: routing, the capacity buffer and the expert
     products in plain PyTorch, as the reference runs them in XLA): (a)
     dbrx-132b **cut to 8 of its 40 layers** (27.3 B parameters, 50.9
     GiB; 245 GiB at full depth) and (b) kimi-k2-1t-a32b **cut to 2 of its
     61 layers** (36.4 B parameters, 67.8 GiB; 17 B a layer), each served
     on phase 4's trace with phase 4's engine (a 2 GiB and a 1 GiB pool):
     one chunk launch per layer per prefill chunk and one paged decode
     per layer per decode step (kimi-k2's at hd 112, n_rep 8), decode step
     and chunk ms, the capacity's drop share per layer in prefill and in
     decode (factor 1.25), the decode step beside the HBM floor of the
     capacity form (it reads every expert's weights each step), the peak
     beside its reckoning; (c) dbrx-132b widths **cut to 1 of 40 layers**
     (4.49 B parameters; two layers' training state would not fit) trained
     at S 4096, micro batch 1, remat, ``for_lm(moe_groups=1)`` on the
     moment tier, sgd with momentum 0.9, DiveBatch (m0 2, m_max 4), 6
     steps: each step's ms, ``ce_loss`` and ``moe_aux``, exactly 2 chunk, 1
     dq and 1 dk/dv launches per microbatch on the tensor cores, model
     FLOP/s (6 N_active S plus attention), the peak beside its reckoning;
     (d) one full-width layer of each, 256 tokens: ``moe_apply`` at
     capacity E / top_k against the dense ``moe_reference`` and at 1.25
     against a plain loop over the kept assignments (dropped counts
     equal), at 2e-2;
 20. the reference's reduced MoE configs (hd 16, float32) on the card
     against the CPU: dbrx-132b and kimi-k2-1t-a32b each serve phase 18's
     trace (first logits within 1e-4, tokens identical); one loss at
     capacity factor 1.0 (B 4, S 64, 2 groups) within 1e-4 with every
     layer's dropped count above 0 and equal on both; 6 moment-tier
     DiveBatch steps in 2 groups, losses, ``moe_aux`` and parameters
     within 1e-4, one schedule; 2 gram-tier steps with probes on the
     attention layers, losses and ``sq_norm_sum`` within 1e-4 relative,
     parameters within 1e-4;
 21. the Mamba family at full width, weights from a seeded generator, bf16,
     each model freed before the next (the Mamba mixer is
     ``models/ssm.py``: the projections, the convolution and a log-depth
     doubling scan in plain PyTorch, as the reference runs them in XLA):
     (a) falcon-mamba-7b at all 64 layers (7.27 B parameters, 13.56 GiB)
     served through ``ServeEngine`` (4 slots, max_seq 16384, block 16,
     prefill chunk 256) on 5 greedy requests of 32 new tokens: one prompt
     of 8192 tokens, three of 64-700 and a repeat of one (a full-prompt
     hit replaying its cached Mamba states); no kernel launch (no
     attention); decode step and chunk ms beside the HBM floor, a slot's
     36.70 MB of state beside a dense KV cache of the long context, the
     scan's share of a chunk, the peak beside its reckoning; (b)
     falcon-mamba widths **cut to 4 of 64 layers**, S 4096, micro batch 2,
     remat (each layer and each scan chunk checkpointed), ``for_lm`` on the
     moment tier, DiveBatch (m0 2, m_max 4, granule 2), 3 steps (4 before
     phase 33 joined): finite losses, step
     ms, model FLOP/s (6 x the products' parameters x tokens), the scan's
     share of a step, the peak beside its reckoning; (c) jamba-v0.1-52b
     **cut to 8 of 32 layers** (one period: 13.30 B parameters, 24.77 GiB;
     96 GiB at full depth) on phase 4's trace and engine: one chunk launch
     per prefill chunk and one paged decode per decode step (its attention
     layer, 32/8 heads, n_rep 4), decode step and chunk ms, the drop share
     per MoE layer, the peak beside its reckoning;
 22. the reference's reduced Mamba configs (float32) on the card against
     the CPU: falcon-mamba-7b and jamba-v0.1-52b each serve phase 18's
     trace (first logits within 1e-4, tokens identical, a full-prompt hit;
     jamba's chunk and decode on the FMA kernels at hd 16); 6 moment-tier
     DiveBatch steps each (jamba's MoE in 2 groups, its attention on the
     FMA forward, dq and dk/dv), losses and parameters within 1e-4, one
     schedule; jamba's 2 gram-tier steps (probes on the attention and
     dense-FFN layers), losses, ``sq_norm_sum`` and parameters within
     1e-4;
 23. the exact tier at full width, per-sample gradients by
     ``torch.func.vmap(grad(example_loss))`` (``make_train_step(estimator=
     "exact", psn_impl="vmap", psn_chunk=2)`` through a hand-built
     ``StepEngine`` and ``train_lm.train``; ``example_loss`` the LM loss of
     one sequence; the layers run without remat inside the transform): (a)
     phase 6's model and cut (Yi-6B widths, 8 of 32 layers, bf16, S 2048,
     micro batch 2, sgd with momentum 0.9, lr 0.02), 4 steps at batch 4:
     finite losses and Delta, launches exactly 24 forward, 16 dq and 16
     dk/dv per microbatch (the main pass's 16, 8, 8 plus one of each per
     layer for the fold of 2 samples: the vmap rule, not a loop), all on
     the tensor cores; step ms beside phases 6 and 8, the per-sample pass's
     share of a microbatch, the peak beside its reckoning; the microbatch's
     norms held against a loop of ``torch.autograd.grad`` over its samples
     on the card within 1e-3 relative (bf16 gradients; the same kernels at
     B 1), and the probe path's estimate (``psn_impl="kernel"``) beside
     them, unchecked; (b) hubert-xlarge widths **cut to 12 of 48 layers**
     (non-causal hd 80), 2 steps: 36, 24, 24 launches per microbatch;
 24. the exact tier on the reference's reduced configs of all ten
     architectures (float32, remat on): per-sample norms of 3 sequences by
     vmap on the card (kernels) against the CPU (plain versions) within
     1e-4 relative, on the ``pallas`` (the FMA kernels at hd 16: one
     forward, dq and dk/dv per attention layer for the fold of 3),
     ``flash`` and ``dense`` lanes;
 25. the training state sharded over ranks (``dist.sharding.StateLayout``):
     (a) Yi-6B widths at 4 of 32 layers, bf16, remat, S 2048, trained 3
     moment-tier steps under a DiveBatch program (batch 2, a sequence per
     rank, a tick every 2 steps) on 2 gloo ranks sharing the card, a
     ``(data 2)`` rung (``fsdp = ep = data``, no tp), against the same run
     whole on one process: batches and buckets equal, losses within 1e-3
     relative, the gathered parameters within 1e-3; each rank's resident
     bytes (parameters, momenta, ``grad_sum``, leaf by leaf) equal to the
     reckoning from ``infer_pspecs``; the collectives by kind each step
     (``CollectiveClock``); exactly 8, 4, 4 attention launches a
     microbatch; then one gram-tier step (8, 4, 4 and 12 gram, 2 fused psgn
     launches).  (b) The first step at an NCCL world of one, to the bit of
     the unsharded step.  (c) dbrx-132b at 1 layer with ``moe_impl="ep"``
     (8 of 16 experts a rank, tokens over ``all_to_all_single``, a
     256-token sequence a rank): two plain sgd steps at capacity 8.0
     against ``moe_apply`` on one process, losses
     within 1e-3 and three gathered leaves within 1e-3; the drops at the
     config's capacity.  (d) reduced Yi-6B: the 2-rank sharded checkpoint
     equals the one-process save of the gathered state byte for byte, and
     restored onto one process its next step's loss is the ranks' within
     1e-5;
 26. reduced Yi-6B, dbrx-132b (``moe_impl="ep"``), falcon-mamba-7b and
     hubert-xlarge sharded on the same 2 ranks (kernels) against one
     process on the CPU with whole state: losses, ``sq_norm_sum`` and the
     gathered parameters within 1e-4, each rank holding fewer parameters
     than the whole;
 27. elastic serving on the card's eight virtual devices: Yi-6B at all 32
     layers, bf16, through ``ServeEngine(elastic=MeshLadder())`` on a
     ramping trace (waves of 1, 2 and 3 requests, the first outliving the
     others): tokens identical to the engine with no ladder, at least 2
     rung transitions, ``compiles`` the distinct (bucket, rung) pairs, the
     launches 32 per chunk and per decode step; decode step and chunk ms by
     rung, each reshard's seconds (a local rung moves no byte);
 28. elastic serving over 2 gloo ranks sharing the card: Yi-6B widths at 2
     of 32 layers (``ELASTIC_LAYERS``) on ``MeshLadder(rank_devices,
     granule=1)`` (widths 1 and 2) through a trace that goes 1 -> 2 -> 1.  The paged decode kernel at
     a rank's rows (B 1, 2, 4) and the chunk kernel at the trace's
     one-chunk prompts held against their plain versions; a world of one
     on NCCL equal to the engine with no ladder to the bit (tokens, pool
     bytes); on each gloo rank the tokens of one process, the parameters
     it holds on the 2-rank rung equal to the reckoning, the launches 4 per
     chunk and per decode step it ran, decode and chunk ms by rung, a
     decode step's collectives by kind (the parameter gathers, the pool
     entries, the token all-reduce, the policy's broadcast), each reshard's
     seconds and the peak; the pools equal across the ranks;
 29. the dry run's plan against the card: phase 6's cut (Yi-6B widths at 8
     of 32 layers, bf16, remat, micro batch 2, S 2048, sgd with momentum
     0.9, 2 microbatches a step) planned on the host by
     ``launch/dryrun.py::trace_train`` (fake tensors, no card), then run on
     the card through ``make_train_step`` on the traced lane
     (``attn_impl="flash"``) and on the kernels (``"pallas"``): the state's
     bytes must equal the plan's exactly, the flash lane's peak
     (``max_memory_allocated``) lie within 25% of the plan's either way,
     and every timed step of both lanes take at least the plan's
     ``step_time_lower_bound_s`` (NVIDIA H100 published peaks at 700 W).
     The dry run of ``yi-6b x train_4k`` on the 256-card ``(16, 16)`` mesh
     runs in a process of its own (CPU only, a fake process group) beside
     the earlier phases, and its one-line summary is printed here;
 30. tensor-parallel training on ranks, run within phase 25's gloo world
     (one spawn less) and reported after phase 29: phase 25's cut (Yi-6B
     widths at 4 of 32 layers, bf16, remat, S 2048, micro batch 2) on its 2
     gloo ranks sharing the card as a ``(data 1, model 2)`` rung
     (``launch.mesh.make_production_mesh(tp=2)``), each block's attention
     heads and FFN widths split over the ranks (``dist.sharding.tp_split``:
     16 query heads over 2 KV heads and 5504 FFN columns a rank), 3
     moment-tier steps under 25a's program then 2 gram-tier steps, against
     the same run on one process with whole state: batches and buckets
     equal, losses and ``sq_norm_sum`` within 1e-3 relative, the gathered
     parameters within 1e-3; each rank's resident bytes equal to the
     reckoning; exactly 8, 4, 4 attention launches a microbatch, the flash
     wrapper seeing 16/2 heads; in the gram tier the psgn kernels reading
     the rank's widths (q 4096 -> 2048, k and v 4096 -> 256, o 2048 ->
     4096, gate and up 4096 -> 5504, down 5504 -> 4096) with the launches
     their grouping gives; ``tp_counts`` every attention and dense FFN
     split, the embedding and head whole; per step its ms, the tensor-
     parallel all-reduces (calls, GB), the collectives by kind beside
     phase 25's block gathers, and each rank's peak beside phase 25's;
 31. tensor-parallel serving on ranks, run within phase 28's gloo world
     (one spawn less) and reported after phase 30: phase 4's model (Yi-6B,
     all 32 layers, bf16, the same seeded weights), engine settings and
     trace on a ``(data 1, model 2)`` rung of the 2 gloo ranks sharing the
     card, served under ``use_plan``: each rank computes its 16 query heads
     over its 2 KV heads, its 5504 FFN columns, its 2048 embedding columns
     and its 32000 logits (two all-reduces a layer, an all-gather each for
     the embedding and the logits), and its pool holds its 2 KV heads.
     Phase 3 holds both kernels at these head counts first (records
     ``chunk_attention (tp rank: 16/2 heads, serving)`` and
     ``paged_decode_attention (tp rank: 16/2 heads)``, rows 1f and 4e).
     Against phase 4's one-process run: the tokens equal up to each
     request's first near-tie (phase 4's top two logits within 4 bf16 ulps
     of the top one; the request, token and gap printed), the first
     tokens' logits within 0.1
     of their largest magnitude (their RMS gap printed), each rank's pool
     exactly half of phase 4's bytes, each rank's parameters equal to the
     specs' reckoning; the kernels seeing 16/2 heads; exactly 32 chunk
     launches a chunk and 32 paged-decode launches a decode step;
     ``tp_counts`` every attention, dense FFN, embedding and head split.
     Printed: decode step and chunk ms beside phase 4's and phase 28's,
     the collectives of a step by kind (tp all-reduces, the embedding and
     logit all-gathers, tokens, the policy), calls, MB and ms, the pool
     and each rank's peak.

 32. context-parallel attention in tensor-parallel training, on 4 gloo
     ranks of a world of their own sharing the card: internvl2-1b at full
     width **cut to 12 of 24 layers** (all 24 before phase 33 joined; d_model
     896, 14/2 heads of hd 64, d_ff 4864, V 151655, the embedding frontend;
     bf16, remat) on a ``(data 1,
     model 4)`` rung, B 2, S 2048: 4 does not divide the 14 heads, so each
     rank projects its 224 q and 32 k/v columns, one all-to-all trades the
     q columns for its 512 query rows of every head, one all-gather joins
     k and v, the flash kernels run its rows at offset ``512 r`` against
     the keys ``[0, 512 (r + 1))``, and the out all-to-all trades back
     before its rows of ``o``; the FFN and the frontend split, the head
     whole (V odd).  3 moment-tier steps under a DiveBatch program, then 2
     gram-tier steps, against the same run on one process with whole
     state: batches and buckets equal, losses and ``sq_norm_sum`` within
     1e-3 relative, the gathered parameters within 1e-3; each rank's
     resident bytes equal to the reckoning; 48, 24, 24 attention launches a
     microbatch, all at the offset form on ranks 1-3 (``kernels.
     offset_counts``) and none on rank 0 (offset 0, as many keys as rows);
     the flash wrapper seeing 14/2 heads over the rank's rows; ``tp_counts``
     attention context-parallel on every layer, the FFN and the frontend
     split, the head whole; the exchanges ``context_parallel_counts``
     reckons a step; in the gram tier the psgn kernels reading the rank's
     columns (q 896 -> 224, k and v 896 -> 32, o 224 -> 896, gate and up
     896 -> 1216, down 1216 -> 896).  Printed: step ms, the exchanges and
     the tp all-reduces, the collectives by kind (calls, GB, ms), each
     rank's peak.  Then rows 1-3 at the offset form on the card: each
     rank's piece held against the plain versions and its forward and
     backward timed (the causal imbalance of contiguous rows: 1, 3, 5 and
     7 of 16 score tiles), qwen2-7b's piece at T 16 (28/4 heads of hd
     128), a non-causal piece (hd 80) and a windowed, softcapped one (hd
     128) held too, and the last rank's piece timed as the records
     ``chunk_attention|flash_dq|flash_dkv (context-parallel rank 3 of 4:
     ...)`` beside SDPA with an explicit boolean mask; their launches are
     phase 32's at the offset form.
 33. the Mamba mixers split over the tensor-parallel ranks in training,
     run within phase 25's gloo world (one spawn less) and reported after
     phase 32: falcon-mamba-7b at full width (d 4096, d_inner 8192, d_state
     16, dt_rank 256, V 65024) **cut to 4 of 64 layers**, bf16, remat, S
     2048, micro batch 2, ssm_chunk 256, 3 moment-tier steps of
     ``make_train_step`` on a ``(data 1, model 2)`` rung of the 2 gloo ranks
     sharing the card: each mixer on the rank's 4096 channels
     (``models/ssm.py::mamba_apply_tp``: one exchange over tp for its
     ``[x_t | z_t]`` rows of ``in_proj``, ``x_proj``'s partial summed over tp
     in float32 with a summed backward, the scan on its channels, its rows
     of ``out_proj`` and one all-reduce), the embedding's d and the head's V
     split.  Against the same run on one process with whole state: losses
     and ``sq_norm_sum`` within 1e-3 relative, the gathered parameters
     within 1e-3; each rank's resident bytes equal to the reckoning; the
     scan seeing 4096 channels and the mixers' products ``in_proj``'s (8192,
     4096) rows, never (16384, 4096); ``tp_counts`` every mixer, the
     embedding and the head split, nothing whole; the mixers' collectives a
     step exactly the reckoning (``ssm.collective_counts``: the
     exchange and the ``x_proj`` all-reduce twice a mixer, the forward's and
     the remat recompute's, the ``out_proj`` all-reduce once, the exchange
     back once and two ``tp.copy`` all-reduces in the backward); no kernel
     launch (no attention).  Printed: step ms beside one process's, the
     mixers' collectives by kind (calls, MB, ms; ``MixerClock``) and every
     collective by kind, each rank's peak.

The line before the kernels' JSON line gives each phase's wall seconds,
header to header (30, 31 and 33 run inside 25 and 28).

Phase 3 also holds the dense group's new forms at their path's shape and
times them (records ``chunk_attention (gemma2 local: window 4096, softcap
50)`` and ``paged_decode_attention (gemma2: softcap 50, n_rep 2)``,
``(llama3: n_rep 16)``; no single library call computes a softcapped or
paged attention, so their library time is null), and the MoE family's:
paged decode at dbrx-132b's 48/8 heads and at kimi-k2's 64/8 of hd 112,
kimi-k2's serving chunk, and dbrx's training form (B 1, S 4096, 48/8
heads: forward, dq and dk/dv on the tensor cores); records ``chunk_attention
(kimi-k2: hd 112, n_rep 8, serving)`` and ``paged_decode_attention
(kimi-k2: hd 112, n_rep 8)``, with SDPA's time; and the Mamba family's
records ``chunk_attention (jamba: n_rep 4, serving)`` and
``paged_decode_attention (jamba: n_rep 4)`` at jamba's serving shapes (32/8
heads of hd 128).

The launches of the non-causal records count phase 14's three paths,
phase 16's hubert run (both ranks) and phase 23b, the dense-form records the phase-17
path they describe (gemma2's serving, llama3's serving), the kimi-k2
records phase 19b's serving path, the jamba records phase 21c's, the
other records
the causal paths (phases 4, 6, 8, 10, 12, 16's pod cell on both
ranks, 23a, 25's sharded training, gram step and dbrx step on both
ranks, 30's tensor-parallel training and gram steps on both ranks, and
31's tensor-parallel serving on both ranks), and phases 27 and 28 (rows 1
and 4: the local ladder, and both ranks of the rank ladder); the tp
serving records (rows 1f, 4e) count phase 31's path.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  A record's ``ms`` is CUDA events
around the call, the host's queueing included where the card waits for it;
``device_ms`` is the same call with the card kept busy until the host has
queued it, the card's time alone.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import diversity  # noqa: E402
from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.data import TokenStream, imagelike_classification  # noqa: E402
from repro_torch.data import sigmoid_synthetic  # noqa: E402
from repro_torch.data.synthetic import ArrayDataset  # noqa: E402
from repro_torch.dist.plan import broadcast_, rank_devices  # noqa: E402
from repro_torch.elastic import place  # noqa: E402
from repro_torch.kernels import _build, ops, psgn, quant, ref  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import data_plan  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.models import moe, probes, resnet, small, ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.pod import PodLadder  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.engine import padded_prompt_len  # noqa: E402
from repro_torch.train import StepEngine, init_state, lm_bucket_of  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.loop import ModelFns, Trainer  # noqa: E402

# H100 SXM peaks at a 700 W limit (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (atol, rtol) of the flash backward's float32 outputs, by input dtype
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 0.0)}
YI = get_config("yi-6b")
NO_PSGN = {"psgn_direct": 0, "psgn_gram": 0, "psgn_fused": 0, "psgn_split": 0,
           "quantize_int8": 0}


#: the script's start, which each phase's header counts its seconds from
T0 = time.perf_counter()


#: (phase number, seconds since the start) of each phase header
PHASE_STARTS: list[tuple[str, float]] = []


def phase(name: str) -> None:
    PHASE_STARTS.append((name.split(" ", 1)[0].rstrip("."), time.perf_counter() - T0))
    print(f"\n== {name} [{time.perf_counter() - T0:.0f} s]", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None


# cycles the card spins before a call timed with ``spin=True`` (about 1 ms
# at the H100's clock), so the host has queued the whole call before its
# start event runs
SPIN_CYCLES = 2_000_000


def timed_ms(fn, iters: int = 10, *, spin: bool = False) -> float:
    """Median time of one call: CUDA events around each call, a 64 MiB
    write between calls so the 50 MB L2 starts cold.  The time includes
    whatever part of the host's work to queue the call (argument checks,
    tensor maps, the launch) the card waits for.  With ``spin`` the card
    spins before the start event, so that host work is hidden and the time
    is the card's alone (the kernel records' ``device_ms``)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check(name: str, got: torch.Tensor, want: torch.Tensor, dtype, *,
          tol: tuple[float, float] | None = None) -> float:
    """Max abs error of ``got``; fails where it passes ``atol + rtol * |want|``
    (both ``TOL[dtype]`` unless ``tol`` gives them)."""
    err = (got.float() - want.float()).abs()
    atol, rtol = tol if tol is not None else (TOL[dtype], TOL[dtype])
    bad = err > atol + rtol * want.float().abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"over tolerance atol {atol}, rtol {rtol} "
                             f"({int(bad.sum())} elements)")
    return err.max().item()


def rms(t: torch.Tensor) -> float:
    return t.float().square().mean().sqrt().item()


ROUTED_ATTENTION = kattn.ROUTED


def attention_routes() -> dict:
    routes = kernels.route_counts()
    return {k: routes[k] for k in ROUTED_ATTENTION}


def plan_of(cfg, dtype) -> dict:
    """``kattn.attention_plan`` at a config's head dim and causality."""
    return kattn.attention_plan(dtype, cfg.resolved_head_dim, cfg.causal)


def attn_routes(counts: dict, plan: dict, *, what: str, routes: dict | None = None) -> None:
    """Every chunk-forward, dq and dk/dv launch of the run just read took the
    route ``plan`` (``kattn.attention_plan``'s) names for its kernel;
    ``routes`` are another process's counts by route (default this one's)."""
    want = {name: {"tc": 0, "fma": 0, plan[name]: counts[name]}
            for name in ROUTED_ATTENTION}
    got = attention_routes() if routes is None else {k: routes[k] for k in ROUTED_ATTENTION}
    if got != want or counts["chunk_attention"] == 0:
        raise AssertionError(f"{what}: attention routes {got}, expected {want}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def chunk_inputs(r, dtype, *, b, c, prior_real, prior_blocks, blk, h, kv, hd,
                 window=None, pad_rows=0):
    """A chunked-prefill attention call: ``prior_real`` valid prior tokens in
    a table of ``prior_blocks`` blocks (the rest sentinel garbage), then the
    chunk's own ``c`` keys; queries at absolute positions from prior_real."""
    prior = prior_blocks * blk
    sk = prior + c
    dev = "cuda"
    q = torch.from_numpy(r.standard_normal((b, c, h, hd))).to(dev, dtype)
    k = torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to(dev, dtype)
    v = torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to(dev, dtype)
    q_pos = prior_real + torch.arange(c, dtype=torch.int32, device=dev)
    if pad_rows:
        q_pos[-pad_rows:] = -(2 ** 30)
    k_pos = torch.cat([torch.arange(prior, dtype=torch.int32, device=dev),
                       prior_real + torch.arange(c, dtype=torch.int32, device=dev)])
    k_valid = torch.cat([torch.arange(prior, device=dev) < prior_real,
                         torch.ones(c, dtype=torch.bool, device=dev)])
    return dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos, k_valid=k_valid,
                window=window)


def chunk_case(name, inp, softcap=None, causal=True):
    dtype = inp["q"].dtype
    args = (inp["q"], inp["k"], inp["v"], inp["q_pos"], inp["k_pos"], inp["k_valid"])
    route = kattn.attention_plan(dtype, inp["q"].shape[-1], causal,
                                 keys=inp["k"].shape[1])["chunk_attention"]
    if route == "tc":
        kattn.tc_key_tiles(reset=True)
    out, lse = kattn.chunk_attention_fwd(*args, window=inp["window"], softcap=softcap,
                                         causal=causal)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref_lse(*args, window=inp["window"], softcap=softcap,
                                           causal=causal)
    err = check(name, out, want, dtype)
    check(name + " lse", lse, want_lse, dtype)
    tiles = ""
    if route == "tc":
        # counted by the kernel's blocks: tiles loaded and multiplied
        seen, total = kattn.tc_key_tiles(reset=True)
        tiles = f"; key tiles visited {seen} of {total}"
    print(f"  chunk {name} [{route}]: max abs err {err:.3e} (tol {TOL[dtype]}){tiles}")
    return err


def valid_pairs(q_pos, k_pos, k_valid, window=None) -> int:
    rel = q_pos[:, None].long() - k_pos[None, :].long()
    ok = (q_pos[:, None] >= 0) & k_valid.bool()[None, :] & (rel >= 0)
    if window is not None:
        ok &= rel < window
    return int(ok.sum())


def chunk_kernel_record(r, cfg=YI, where: str = "the serving shape", **extra) -> dict:
    """The chunk forward at ``cfg``'s serving shape (a 256-token chunk over
    768 valid prior tokens in 64 blocks, bf16) against its plain version,
    timed beside it and beside SDPA; ``extra`` joins the record (its name,
    the paths its launches count)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    inp = chunk_inputs(r, torch.bfloat16, b=1, c=256, prior_real=768,
                       prior_blocks=64, blk=16, h=h, kv=kv, hd=hd)
    tag = "slice shape" if cfg is YI else f"{cfg.name} record"
    err = chunk_case(f"{tag} bf16 (C 256, 768 prior in 64 blocks, Sk 1280, {h}/{kv} heads "
                     f"of hd {hd})", inp)
    args = (inp["q"], inp["k"], inp["v"], inp["q_pos"], inp["k_pos"], inp["k_valid"])
    ms = timed_ms(lambda: kattn.chunk_attention_fwd(*args))
    device_ms = timed_ms(lambda: kattn.chunk_attention_fwd(*args), spin=True)
    plain_ms = timed_ms(lambda: ref.attention_ref_lse(*args))
    # library yardstick: SDPA with the same boolean mask, GQA grouping
    rel = inp["q_pos"][:, None].long() - inp["k_pos"][None, :].long()
    mask = ((rel >= 0) & inp["k_valid"][None, :] & (inp["q_pos"][:, None] >= 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (inp["q"], inp["k"], inp["v"]))
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True))
    pairs = valid_pairs(inp["q_pos"], inp["k_pos"], inp["k_valid"])
    moved = nbytes(*args) + nbytes(inp["q"]) + 256 * h * 4  # + out + lse
    flops = 4 * pairs * h * hd
    bound_ms, by = bound(moved, flops)
    dispatch = kattn.attention_plan(inp["q"].dtype, hd)["chunk_attention"]
    print(f"  chunk_attention at {where} [{dispatch}]: {ms:.4f} ms ({device_ms:.4f} "
          f"on the card alone), {flops / ms / 1e9:.1f} TFLOP/s (library {library_ms:.4f}); "
          f"bound {bound_ms:.4f} ms by {by}, {100 * bound_ms / ms:.1f}% of it")
    return {"name": "chunk_attention", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/chunk_attention{'_tc' if dispatch == 'tc' else ''}.cu",
            "replaces": "src/repro/kernels/attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            "device_ms": device_ms, "dispatch": dispatch, "tflops": flops / ms / 1e9,
            **extra}


def decode_inputs(r, dtype, *, b, blk, n_max, nb, kv, h, hd, max_len):
    dev = "cuda"
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(dev, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(dev, dtype)
    tables = np.zeros((b, n_max), np.int32)
    lengths = r.integers(1, max_len + 1, size=b).astype(np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)  # out-of-order pool ids
    for row in range(b):
        n_live = -(-int(lengths[row]) // blk)
        tables[row, :n_live] = ids[:n_live]  # dead entries stay at sentinel 0
        ids = ids[n_live:]
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(dev, dtype)
    return (q, pool_k, pool_v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))


def decode_case(name, args, softcap=None) -> float:
    dtype = args[0].dtype
    out = kattn.paged_decode_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    want = ref.paged_decode_ref(*args, softcap=softcap)
    err = check(name, out, want, dtype)
    print(f"  decode {name}: max abs err {err:.3e} (tol {TOL[dtype]})")
    return err


def decode_kernel_record(r, cfg=YI, where: str = "the serving shape", **extra) -> dict:
    """Paged decode at ``cfg``'s serving shape (8 slots, block 16, the
    table of max_seq 2048, lengths <= 1100, bf16) against its plain
    version, 20 launches bit-identical, timed beside it and beside SDPA
    over the gathered context; ``extra`` joins the record."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    blk, n_max = 16, 192  # the engine's table width at max_seq 2048
    args = decode_inputs(r, torch.bfloat16, b=8, blk=blk, n_max=n_max, nb=2048,
                         kv=kv, h=h, hd=hd, max_len=1100)
    tag = "slice shape" if cfg is YI else f"{cfg.name} record"
    err = decode_case(f"{tag} bf16 (B 8, block 16, lengths <= 1100, {h}/{kv} heads of hd "
                      f"{hd})", args)
    q, pool_k, pool_v, tables, lengths = args
    splits = kattn.paged_decode_attention.splits
    # a fixed split order and no atomics: the same bits on every launch
    outs = [kattn.paged_decode_attention(*args) for _ in range(20)]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("paged decode: 20 launches gave different bits")
    del outs
    ms = timed_ms(lambda: kattn.paged_decode_attention(*args))
    device_ms = timed_ms(lambda: kattn.paged_decode_attention(*args), spin=True)
    plain_ms = timed_ms(lambda: ref.paged_decode_ref(*args))
    # library yardstick on the materialised gather (the gather is not timed)
    b = q.shape[0]
    idx = tables.reshape(-1).long()
    gk = pool_k[idx].reshape(b, n_max * blk, kv, hd).transpose(1, 2)
    gv = pool_v[idx].reshape(b, n_max * blk, kv, hd).transpose(1, 2)
    mask = torch.arange(n_max * blk, device="cuda")[None, :] < lengths[:, None]
    qt = q.transpose(1, 2)
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, gk, gv, attn_mask=mask[:, None, None, :], enable_gqa=True))
    tokens = int(lengths.sum())
    live_kv = 2 * tokens * kv * hd * pool_k.element_size()
    moved = live_kv + 2 * nbytes(q) + nbytes(tables, lengths)
    bound_ms, by = bound(moved, 4 * tokens * h * hd)
    print(f"  paged_decode_attention at {where}: plan {splits} splits "
          f"({splits * kv * b} blocks); 20 launches bit-identical; {ms:.4f} ms "
          f"({device_ms:.4f} on the card alone; plain {plain_ms:.4f}, library "
          f"{library_ms:.4f}); bound {bound_ms:.4f} ms by {by}, "
          f"{100 * bound_ms / device_ms:.1f}% of it alone")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/attention.py:448",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            "device_ms": device_ms, "splits": splits, **extra}


GEMMA = get_config("gemma2-27b")
LLAMA = get_config("llama3-405b")
# gemma2's serving cell: 4 slots, max_seq 8192, block 16, prefill chunk 256
GEMMA_SLOTS, GEMMA_MAX_SEQ, GEMMA_CHUNK = 4, 8192, 256


def dense_kernel_records(r) -> list[dict]:
    """The forms the dense group adds to the paths, at their path's shape:
    row 1c, the chunk forward of gemma2's sliding-window layers (a 256-row
    chunk over its 4096-key ring read in chronological order, the oldest
    positions cut by the window, then the chunk's keys; 32/16 heads of hd
    128, window 4096, softcap 50, bf16); row 4b, paged decode with softcap
    50 at gemma2's serving shape (4 slots, 32/16 heads, the table of max_seq
    8192) and at llama3's 128/8 heads (n_rep 16, n_rep * hd = 2048, 8
    slots).  Each held against its plain version and timed beside it; no
    single library call computes a softcapped attention or a paged one, so
    the library column is none."""
    h, kv, hd = GEMMA.num_heads, GEMMA.num_kv_heads, GEMMA.resolved_head_dim
    c, s_c, offset = GEMMA_CHUNK, GEMMA.window, 6144
    dev = "cuda"
    q = torch.from_numpy(r.standard_normal((1, c, h, hd))).to(dev, torch.bfloat16)
    k = torch.from_numpy(r.standard_normal((1, s_c + c, kv, hd))).to(dev, torch.bfloat16)
    v = torch.from_numpy(r.standard_normal((1, s_c + c, kv, hd))).to(dev, torch.bfloat16)
    q_pos = offset + torch.arange(c, dtype=torch.int32, device=dev)
    prior = offset - s_c + torch.arange(s_c, dtype=torch.int32, device=dev)
    inp = dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=torch.cat([prior, q_pos]),
               k_valid=torch.cat([(prior >= 0).to(torch.int32), torch.ones_like(q_pos)]),
               window=s_c)
    cap = GEMMA.attn_softcap
    err = chunk_case(f"gemma2 local chunk bf16 (C {c} at {offset} over a {s_c}-key ring, "
                     f"window {s_c}, softcap {cap:g})", inp, softcap=cap)
    args = (q, inp["k"], inp["v"], q_pos, inp["k_pos"], inp["k_valid"])
    kw = dict(window=s_c, softcap=cap)
    ms = timed_ms(lambda: kattn.chunk_attention_fwd(*args, **kw))
    device_ms = timed_ms(lambda: kattn.chunk_attention_fwd(*args, **kw), spin=True)
    plain_ms = timed_ms(lambda: ref.attention_ref_lse(*args, **kw))
    pairs = valid_pairs(q_pos, inp["k_pos"], inp["k_valid"], window=s_c)
    moved = nbytes(*args) + nbytes(q) + c * h * 4  # + out + lse
    flops = 4 * pairs * h * hd
    bound_ms, by = bound(moved, flops)
    dispatch = kattn.attention_plan(q.dtype, hd, keys=s_c + c)["chunk_attention"]
    print(f"  chunk_attention at gemma2's local serving shape [{dispatch}]: {ms:.4f} ms "
          f"({device_ms:.4f} on the card alone), {flops / ms / 1e9:.1f} TFLOP/s; plain "
          f"{plain_ms:.4f}, library none; bound {bound_ms:.4f} ms by {by}, "
          f"{100 * bound_ms / ms:.1f}% of it")
    records = [{"name": "chunk_attention (gemma2 local: window 4096, softcap 50)",
                "counter": "chunk_attention windowed", "paths": ["gemma2-27b serving"],
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/chunk_attention{'_tc' if dispatch == 'tc' else ''}.cu",
                "replaces": "src/repro/kernels/attention.py:92",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": None, "device_ms": device_ms,
                "dispatch": dispatch, "tflops": flops / ms / 1e9}]
    del q, k, v, inp, args
    span = GEMMA_MAX_SEQ + GEMMA_MAX_SEQ // 2
    for cfg, b, n_max, max_len, softcap, path in (
            (GEMMA, GEMMA_SLOTS, span // 16, span, cap, "gemma2-27b serving"),
            (LLAMA, 8, 192, 1100, None, "llama3-405b serving")):
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        args = decode_inputs(r, torch.bfloat16, b=b, blk=16, n_max=n_max,
                             nb=b * n_max + 1, kv=kv, h=h, hd=hd, max_len=max_len)
        label = (f"{cfg.name} bf16 (B {b}, {h}/{kv} heads, n_rep {h // kv}, block 16, "
                 f"n_max {n_max}, lengths <= {max_len}"
                 + (f", softcap {softcap:g})" if softcap else ")"))
        err = decode_case(label, args, softcap=softcap)
        splits = kattn.paged_decode_attention.splits
        ms = timed_ms(lambda: kattn.paged_decode_attention(*args, softcap=softcap))
        device_ms = timed_ms(lambda: kattn.paged_decode_attention(*args, softcap=softcap),
                             spin=True)
        plain_ms = timed_ms(lambda: ref.paged_decode_ref(*args, softcap=softcap))
        q, pool_k, _, tables, lengths = args
        tokens = int(lengths.sum())
        moved = 2 * tokens * kv * hd * pool_k.element_size() + 2 * nbytes(q) + \
            nbytes(tables, lengths)
        bound_ms, by = bound(moved, 4 * tokens * h * hd)
        print(f"  paged_decode_attention at {cfg.name}'s serving shape: {splits} splits; "
              f"{ms:.4f} ms ({device_ms:.4f} on the card alone; plain {plain_ms:.4f}, "
              f"library none); bound {bound_ms:.4f} ms by {by}, "
              f"{100 * bound_ms / device_ms:.1f}% of it alone")
        form = "softcap 50, n_rep 2" if softcap else "n_rep 16"
        records.append({
            "name": f"paged_decode_attention ({cfg.name.split('-')[0]}: {form})",
            "counter": "paged_decode_attention", "paths": [path], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/attention.py:448", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "device_ms": device_ms, "splits": splits})
        del args, q, pool_k, tables, lengths
    return records


def dense_serving_cases(r) -> None:
    """The chunk forward and paged decode at the dense group's other serving
    shapes (phase 17b's engine: prefill chunk 256 over a prior of 768 valid
    tokens in 64 blocks; decode at B 8, block 16, n_max 192): qwen2-7b's
    28/4 heads (n_rep 7) and llama3-405b's 128/8 (n_rep 16, n_rep * hd =
    2048); gemma2's global layers (a chunk over the pool's prior, softcap
    50, no window); internvl2-1b's ``prefill_step`` (B 4, S 1024, 14/2
    heads of hd 64)."""
    bf = torch.bfloat16
    for cfg in (get_config("qwen2-7b"), LLAMA):
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        chunk_case(f"{cfg.name} serving shape bf16 (C 256, 768 prior in 64 blocks, "
                   f"{h}/{kv} heads)",
                   chunk_inputs(r, bf, b=1, c=256, prior_real=768, prior_blocks=64, blk=16,
                                h=h, kv=kv, hd=hd))
        decode_case(f"{cfg.name} serving shape bf16 (B 8, {h}/{kv} heads, n_rep {h // kv}, "
                    f"block 16, n_max 192, lengths <= 1100)",
                    decode_inputs(r, bf, b=8, blk=16, n_max=192, nb=2048, kv=kv, h=h, hd=hd,
                                  max_len=1100))
    h, kv, hd = GEMMA.num_heads, GEMMA.num_kv_heads, GEMMA.resolved_head_dim
    chunk_case(f"gemma2 global chunk bf16 (C 256 after 4864 pool keys in 320 blocks, "
               f"softcap {GEMMA.attn_softcap:g})",
               chunk_inputs(r, bf, b=1, c=256, prior_real=4864, prior_blocks=320, blk=16,
                            h=h, kv=kv, hd=hd), softcap=GEMMA.attn_softcap)
    cfg = get_config("internvl2-1b")
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    chunk_case(f"internvl2-1b prefill_step shape bf16 (B 4, S 1024, {h}/{kv} heads of hd {hd})",
               chunk_inputs(r, bf, b=4, c=1024, prior_real=0, prior_blocks=0, blk=16, h=h,
                            kv=kv, hd=hd))


def gemma_train_attention_case(r) -> None:
    """gemma2's training attention at phase 17d's shape: B 1, S 8192, 32/16
    heads of hd 128, window 4096 (it cuts every row past 4096), softcap 50,
    bf16."""
    train_attention_case(r, "gemma2 training form", GEMMA, GEMMA_TRAIN_SEQ,
                         window=GEMMA.window, cap=GEMMA.attn_softcap)


def train_attention_case(r, label: str, cfg, s: int, *, window=None, cap=None) -> None:
    """A config's training attention at B 1, S ``s`` in bf16: the chunk
    forward, flash dq and flash dk/dv against their plain versions, each
    plain call taken over one KV head and its n_rep query heads (an (n_rep,
    S, S) float32 logit block; the heads do not interact)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bf = torch.bfloat16
    inp = flash_inputs(r, bf, b=1, s=s, h=h, kv=kv, hd=hd, window=window, softcap=cap)
    q, k, v, dout, out, lse, delta = (inp[n] for n in
                                      ("q", "k", "v", "dout", "out", "lse", "delta"))
    kw = dict(window=window, softcap=cap)
    dq = kattn.flash_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = kattn.flash_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    n_rep, tol = h // kv, FLASH_TOL[bf]
    errs = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0.0)
    for g in range(kv):
        hs, ks = slice(g * n_rep, (g + 1) * n_rep), slice(g, g + 1)
        qg, kg, vg = q[:, :, hs], k[:, :, ks], v[:, :, ks]
        want_out, want_lse = ref.attention_ref_lse(qg, kg, vg, pos, pos, torch.ones_like(pos),
                                                   **kw)
        want = ref.flash_grads_ref(qg, kg, vg, lse[:, hs], delta[:, hs], dout[:, :, hs], **kw)
        for key, got, plain, t in (("out", out[:, :, hs], want_out, None),
                                   ("lse", lse[:, hs], want_lse, None),
                                   ("dq", dq[:, :, hs], want[0], tol),
                                   ("dk", dk[:, :, ks], want[1], tol),
                                   ("dv", dv[:, :, ks], want[2], tol)):
            errs[key] = max(errs[key], check(f"{label}, KV head {g}, {key}",
                                             got, plain, bf, tol=t))
        del want_out, want_lse, want
    plan = kattn.attention_plan(bf, hd)
    form = (f", window {window}" if window else "") + (f", softcap {cap:g}" if cap else "")
    print(f"  {label} bf16 (B 1, S {s}, {h}/{kv} heads{form}) "
          f"[forward {plan['chunk_attention']}, dq {plan['flash_dq']}, "
          f"dk/dv {plan['flash_dkv']}]: max abs err out {errs['out']:.3e}, lse "
          f"{errs['lse']:.3e} (tol {TOL[bf]}); dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, "
          f"dv {errs['dv']:.3e} (atol {tol[0]}, rtol {tol[1]}); rms dq {rms(dq):.3e}, "
          f"dk {rms(dk):.3e}, dv {rms(dv):.3e}")
    del inp, q, k, v, dout, out, lse, delta, dq, dk, dv


DBRX = get_config("dbrx-132b")
KIMI = get_config("kimi-k2-1t-a32b")
MOE_TRAIN_SEQ = 4096


def moe_attention_cases(r) -> None:
    """The attention forms the MoE family puts on paths (phase 19) that the
    kimi-k2 records do not hold, at their path's shapes: dbrx-132b's 48/8
    heads of hd 128 (n_rep 6) in its serving chunk (C 256 over a prior of
    768 valid tokens in 64 blocks) and paged decode (8 slots, block 16,
    n_max 192, lengths <= 1100), and dbrx's training form (B 1, S 4096,
    48/8 heads: the forward, dq and dk/dv on the tensor cores)."""
    h, kv, hd = DBRX.num_heads, DBRX.num_kv_heads, DBRX.resolved_head_dim
    chunk_case(f"{DBRX.name} serving shape bf16 (C 256, 768 prior in 64 blocks, {h}/{kv} "
               f"heads of hd {hd})",
               chunk_inputs(r, torch.bfloat16, b=1, c=256, prior_real=768, prior_blocks=64,
                            blk=16, h=h, kv=kv, hd=hd))
    decode_case(f"{DBRX.name} serving shape bf16 (B 8, {h}/{kv} heads of hd {hd}, n_rep "
                f"{h // kv}, block 16, n_max 192, lengths <= 1100)",
                decode_inputs(r, torch.bfloat16, b=8, blk=16, n_max=192, nb=2048, kv=kv, h=h,
                              hd=hd, max_len=1100))
    train_attention_case(r, "dbrx-132b training form", DBRX, MOE_TRAIN_SEQ)


def moe_kernel_records(r) -> list[dict]:
    """Rows 1d and 4c: the chunk forward and paged decode at kimi-k2's
    serving shapes (64/8 heads of hd 112, n_rep 8), their launches counted
    on phase 19b's kimi-k2 serving path."""
    path = {"paths": ["kimi-k2-1t-a32b serving"]}
    return [chunk_kernel_record(r, KIMI, "kimi-k2's serving shape", counter="chunk_attention",
                                name="chunk_attention (kimi-k2: hd 112, n_rep 8, serving)",
                                **path),
            decode_kernel_record(r, KIMI, "kimi-k2's serving shape",
                                 counter="paged_decode_attention",
                                 name="paged_decode_attention (kimi-k2: hd 112, n_rep 8)",
                                 **path)]


def decode_split_cases(r) -> None:
    """The split decode at its edges, at the serving widths (B 8, 32/4
    heads, hd 128, block 16, n_max 192: the plan's 9 splits on 132 SMs), in
    both types: lengths 1 and one block, a length on a split boundary (288:
    18 entries in shares of 2) and one token either side (289 leaves one
    token in the seventh share and two empty shares), a full table, and two
    free lanes whose tables are all sentinel (lengths that kept counting,
    the second past the table)."""
    h, kv, hd = YI.num_heads, YI.num_kv_heads, YI.resolved_head_dim
    blk, n_max = 16, 192
    lens = [1, blk, 287, 288, 289, n_max * blk, 37, 5000]
    tables = np.zeros((len(lens), n_max), np.int32)
    ids = list(range(1, 2048))
    r.shuffle(ids)
    for row, n in enumerate(lens[:6]):
        live = -(-n // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    for dtype in (torch.float32, torch.bfloat16):
        q, pool_k, pool_v, _, _ = decode_inputs(r, dtype, b=len(lens), blk=blk, n_max=n_max,
                                                nb=2048, kv=kv, h=h, hd=hd, max_len=1)
        args = (q, pool_k, pool_v, torch.from_numpy(tables).to("cuda"),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        tag = "f32" if dtype == torch.float32 else "bf16"
        decode_case(f"{tag} split edges (lengths {lens}, rows 6-7 all sentinel)", args)
        print(f"    ({kattn.paged_decode_attention.splits} splits)")


def flash_inputs(r, dtype, *, b, s, h, kv, hd, window=None, softcap=None,
                 causal=True) -> dict:
    """One flash backward call: q, k, v, dout and the card forward's out and
    lse, the pairing the training path uses."""
    dev = "cuda"
    q = torch.from_numpy(r.standard_normal((b, s, h, hd))).to(dev, dtype)
    k = torch.from_numpy(r.standard_normal((b, s, kv, hd))).to(dev, dtype)
    v = torch.from_numpy(r.standard_normal((b, s, kv, hd))).to(dev, dtype)
    dout = torch.from_numpy(r.standard_normal((b, s, h, hd))).to(dev, dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    out, lse = kattn.chunk_attention_fwd(q, k, v, pos, pos, torch.ones_like(pos),
                                         window=window, softcap=softcap, causal=causal)
    return dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse,
                delta=ref.flash_delta(out, dout), window=window, softcap=softcap,
                causal=causal)


def flash_case(name, inp) -> tuple[float, float]:
    dtype = inp["q"].dtype
    kw = dict(window=inp["window"], softcap=inp["softcap"], causal=inp["causal"])
    args = (inp["q"], inp["k"], inp["v"], inp["dout"], inp["lse"], inp["delta"])
    dq = kattn.flash_dq(*args, **kw)
    dk, dv = kattn.flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    want = ref.flash_backward_ref(inp["q"], inp["k"], inp["v"], inp["out"], inp["lse"],
                                  inp["dout"], **kw)
    tol = FLASH_TOL[dtype]
    err_dq = check(name + " dq", dq, want[0], dtype, tol=tol)
    err_dkv = max(check(name + " dk", dk, want[1], dtype, tol=tol),
                  check(name + " dv", dv, want[2], dtype, tol=tol))
    plan = kattn.attention_plan(dtype, inp["q"].shape[-1], inp["causal"])
    print(f"  flash backward {name} [dq {plan['flash_dq']}, dk/dv {plan['flash_dkv']}]: "
          f"max abs err dq {err_dq:.3e}, "
          f"dk/dv {err_dkv:.3e} "
          f"(atol {tol[0]}, rtol {tol[1]}); rms of the plain dq {rms(want[0]):.3e}, "
          f"dk {rms(want[1]):.3e}, dv {rms(want[2]):.3e}")
    return err_dq, err_dkv


def flash_kernel_records(r) -> list[dict]:
    """dq and dk/dv at the training shape: B 2, S 2048, Yi-6B heads, bf16."""
    b, s = 2, 2048
    h, kv, hd = YI.num_heads, YI.num_kv_heads, YI.resolved_head_dim
    inp = flash_inputs(r, torch.bfloat16, b=b, s=s, h=h, kv=kv, hd=hd)
    err_dq, err_dkv = flash_case(f"slice shape bf16 (B {b}, S {s})", inp)
    q, k, v, dout, lse, delta = (inp[n] for n in ("q", "k", "v", "dout", "lse", "delta"))
    dq_ms = timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta))
    dkv_ms = timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta))
    dq_dev = timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta), spin=True)
    dkv_dev = timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta), spin=True)
    # the plain version computes dq, dk and dv in one call
    plain_ms = timed_ms(lambda: ref.flash_grads_ref(q, k, v, lse, delta, dout))
    # library yardstick: the backward of SDPA (dq, dk and dv in one call)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = dout.transpose(1, 2)
    library_ms = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                      retain_graph=True))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    ones = torch.ones_like(pos)
    # the forward at the training shape against its plain version
    fwd_err = chunk_case(f"training shape bf16 (B {b}, S {s}, {h}/{kv} heads)",
                         dict(q=q, k=k, v=v, q_pos=pos, k_pos=pos, k_valid=ones, window=None))
    fwd_ms = timed_ms(lambda: kattn.chunk_attention_fwd(q, k, v, pos, pos, ones))
    fwd_dev = timed_ms(lambda: kattn.chunk_attention_fwd(q, k, v, pos, pos, ones), spin=True)
    with torch.no_grad():
        sdpa_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = b * h * s * (s + 1) // 2  # causal (row, key) pairs over all (b, h)
    # the forward: q k^T and p v, 2 hd multiply-adds per causal pair; q, k, v
    # read once and the output written once
    fwd_bound, fwd_by = bound(nbytes(q, k, v, q), 4 * hd * pairs)
    plan = kattn.attention_plan(q.dtype, hd)
    print(f"  chunk_attention at the training shape (B {b}, S {s}, causal) "
          f"[{plan['chunk_attention']}]: {fwd_ms:.4f} ms ({fwd_dev:.4f} on the card "
          f"alone), {4 * hd * pairs / fwd_ms / 1e9:.1f} TFLOP/s (library {sdpa_ms:.4f}: SDPA "
          f"forward); bound {fwd_bound:.4f} ms by {fwd_by}, {100 * fwd_bound / fwd_ms:.1f}% of "
          f"it; max abs err {fwd_err:.3e}")
    read = nbytes(q, k, v, dout, lse, delta)
    dq_bound, dq_by = bound(read + b * s * h * hd * 4, 3 * 2 * hd * pairs)
    dkv_bound, dkv_by = bound(read + 2 * b * s * kv * hd * 4, 4 * 2 * hd * pairs)
    for label, ms, dev, flops, bnd in (
            (f"flash_dq [{plan['flash_dq']}]", dq_ms, dq_dev, 3 * 2 * hd * pairs, dq_bound),
            (f"flash_dkv [{plan['flash_dkv']}]", dkv_ms, dkv_dev, 4 * 2 * hd * pairs,
             dkv_bound)):
        print(f"  {label} at the training shape: {ms:.4f} ms ({dev:.4f} on the card alone), "
              f"{flops / ms / 1e9:.1f} TFLOP/s (library {library_ms:.4f}: SDPA backward); "
              f"bound {bnd:.4f} ms, {100 * bnd / ms:.1f}% of it")
    del out, qt, kt, vt, inp
    common = {"route": "cuda", "plain_ms": plain_ms, "library_ms": library_ms}
    tc = {n: "_tc" if plan[n] == "tc" else "" for n in ROUTED_ATTENTION}
    return [
        {"name": "flash_dq", "source": f"src/repro_torch/kernels/csrc/flash_dq{tc['flash_dq']}.cu",
         "replaces": "src/repro/kernels/attention.py:218", "max_abs_err": err_dq,
         "ms": dq_ms, "bound_ms": dq_bound, "bound_by": dq_by, **common,
         "device_ms": dq_dev, "dispatch": plan["flash_dq"],
         "tflops": 3 * 2 * hd * pairs / dq_ms / 1e9},
        {"name": "flash_dkv",
         "source": f"src/repro_torch/kernels/csrc/flash_dkv{tc['flash_dkv']}.cu",
         "replaces": "src/repro/kernels/attention.py:245", "max_abs_err": err_dkv,
         "ms": dkv_ms, "bound_ms": dkv_bound, "bound_by": dkv_by, **common,
         "device_ms": dkv_dev, "dispatch": plan["flash_dkv"],
         "tflops": 4 * 2 * hd * pairs / dkv_ms / 1e9},
    ]


def tc_attention_cases(r) -> None:
    """The tensor-core chunk forward, dq and dk/dv (bf16) at the edges the
    loops above do not reach, and a forward past the tensor-core key cap."""
    bf = torch.bfloat16
    chunk_case("tc n_rep 4, C 45 < 64, Sk 301, softcap 30, window 50 across tiles",
               chunk_inputs(r, bf, b=2, c=45, prior_real=200, prior_blocks=16, blk=16,
                            h=8, kv=2, hd=128, window=50), softcap=30.0)
    chunk_case("tc hd 64, n_rep 1, a prior table of 40 blocks with 100 valid tokens "
               "(sentinel-only tail tiles)",
               chunk_inputs(r, bf, b=1, c=70, prior_real=100, prior_blocks=40, blk=16,
                            h=4, kv=4, hd=64))
    chunk_case("tc hd 64, one query row (C 1)",
               chunk_inputs(r, bf, b=3, c=1, prior_real=33, prior_blocks=4, blk=16, h=4,
                            kv=2, hd=64))
    # rows 10-12's keys within the window (3) are all invalid: row 12 attends
    # no key at all and takes the mean of v over every key
    inp = chunk_inputs(r, bf, b=1, c=40, prior_real=0, prior_blocks=0, blk=16, h=8, kv=1,
                       hd=128, window=3)
    inp["k_valid"][10:13] = False
    chunk_case("tc n_rep 8, a live row with no attendable key (window 3)", inp)
    # keys shuffled (k_pos not monotonic) at positions past the array bounds
    inp = chunk_inputs(r, bf, b=2, c=100, prior_real=300, prior_blocks=25, blk=16, h=8,
                       kv=2, hd=64)
    perm = torch.from_numpy(r.permutation(inp["k"].shape[1])).to("cuda")
    for key in ("k", "v"):
        inp[key] = inp[key][:, perm].contiguous()
    inp["k_pos"] = inp["k_pos"][perm] + 5000
    inp["k_valid"] = inp["k_valid"][perm]
    inp["q_pos"] = inp["q_pos"] + 5000
    chunk_case("tc shuffled keys, positions past the array bounds (+5000)", inp)
    chunk_case("tc 128-row blocks (B 2, C 300, 32/4 heads), 7 padded rows, softcap 20, "
               "window 200",
               chunk_inputs(r, bf, b=2, c=300, prior_real=500, prior_blocks=40, blk=16,
                            h=32, kv=4, hd=128, window=200, pad_rows=7), softcap=20.0)
    flash_case("tc n_rep 4, hd 64, ragged S 200, window 70",
               flash_inputs(r, bf, b=2, s=200, h=8, kv=2, hd=64, window=70))
    flash_case("tc n_rep 4, hd 128, ragged S 129, softcap 30",
               flash_inputs(r, bf, b=1, s=129, h=16, kv=4, hd=128, softcap=30.0))
    # dq's 128-row blocks: a single row, ragged and whole 64-row tiles, a
    # block whose second warpgroup has no row, n_rep 1, 2 and 8 in turn
    n_reps = (1, 2, 8)
    for i, (s, hd) in enumerate((s, hd) for s in (1, 63, 64, 65, 129, 300) for hd in (64, 128)):
        n_rep = n_reps[i % 3]
        kv = 8 // n_rep if n_rep < 8 else 1
        flash_case(f"tc S {s}, hd {hd}, n_rep {n_rep}",
                   flash_inputs(r, bf, b=2, s=s, h=kv * n_rep, kv=kv, hd=hd))
    flash_case("tc n_rep 2, hd 128, S 300, window 70 across tiles",
               flash_inputs(r, bf, b=1, s=300, h=8, kv=4, hd=128, window=70))
    flash_case("tc n_rep 8, hd 64, S 200, softcap 20",
               flash_inputs(r, bf, b=1, s=200, h=16, kv=2, hd=64, softcap=20.0))
    # causal at hd 80 and 112 (kimi-k2's head dim): all three on the tensor
    # cores
    flash_case("causal hd 80, n_rep 1, ragged S 300",
               flash_inputs(r, bf, b=2, s=300, h=4, kv=4, hd=80))
    flash_case("causal hd 112, n_rep 4, S 129, window 50, softcap 30",
               flash_inputs(r, bf, b=1, s=129, h=8, kv=2, hd=112, window=50, softcap=30.0))
    chunk_case("causal hd 112, n_rep 4, a prefill chunk (sentinel keys, 5 padded rows)",
               chunk_inputs(r, bf, b=1, c=70, prior_real=90, prior_blocks=8, blk=16, h=8,
                            kv=2, hd=112, pad_rows=5))
    key_cap_case(r)


def key_cap_case(r) -> None:
    """A bf16 chunk forward over one key more than the tensor-core kernel's
    tile list holds (hd 128, causal, a 16-row chunk at the end of the
    context): planned onto the FMA kernel, against the plain version."""
    sk, c, h, kv, hd = kattn.TC_MAX_KEYS + 1, 16, 8, 2, 128
    bf = torch.bfloat16
    k_pos = torch.arange(sk, dtype=torch.int32, device="cuda")
    inp = dict(q=torch.from_numpy(r.standard_normal((1, c, h, hd))).to("cuda", bf),
               k=torch.from_numpy(r.standard_normal((1, sk, kv, hd))).to("cuda", bf),
               v=torch.from_numpy(r.standard_normal((1, sk, kv, hd))).to("cuda", bf),
               q_pos=k_pos[-c:].clone(), k_pos=k_pos, k_valid=torch.ones_like(k_pos),
               window=None)
    before = dict(kattn.chunk_attention.routes)
    chunk_case(f"bf16 hd {hd}, {sk} keys (one past the tensor-core cap), C {c}", inp)
    if kattn.chunk_attention.routes != {**before, "fma": before["fma"] + 1}:
        raise AssertionError(f"{sk} keys: routes {kattn.chunk_attention.routes}, before "
                             f"{before}")


# the non-causal cases: (hd, n_rep, S, softcap) at each head dim with a
# kernel, each run without a window and with one (one-sided without
# causality: a row sees every later key)
NONCAUSAL_CASES = ((16, 4, 45, 15.0), (32, 1, 16, None), (64, 4, 150, 30.0),
                   (80, 1, 300, None), (112, 4, 129, 20.0), (128, 4, 70, None))


def noncausal_cases(r) -> None:
    """The chunk forward, dq and dk/dv without causality against their plain
    versions, float32 and bf16, at hd 16, 32, 64, 80, 112 and 128, with and
    without a window, n_rep 1 and 4, softcaps and ragged S; then a prefill
    chunk with sentinel keys and padded rows.  Every launch takes the route
    the plan names for its kernel (in bf16 at hd 64 and above all three on
    the tensor cores)."""
    kernels.reset_launch_counts()
    want = {n: {"tc": 0, "fma": 0} for n in ROUTED_ATTENTION}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for hd, n_rep, s, cap in NONCAUSAL_CASES:
            for window in (None, s // 3):
                kv = 4 // n_rep if n_rep < 4 else 2
                inp = flash_inputs(r, dtype, b=2, s=s, h=kv * n_rep, kv=kv, hd=hd,
                                   window=window, softcap=cap, causal=False)
                name = (f"non-causal {tag} hd {hd}, n_rep {n_rep}, S {s}"
                        + (f", window {window}" if window else "")
                        + (f", softcap {cap}" if cap else ""))
                pos = torch.arange(s, dtype=torch.int32, device="cuda")
                chunk_case(name, dict(q=inp["q"], k=inp["k"], v=inp["v"], q_pos=pos,
                                      k_pos=pos, k_valid=torch.ones_like(pos),
                                      window=window), softcap=cap, causal=False)
                flash_case(name, inp)
                # two chunk forwards (the inputs' and the case's), one dq, one dk/dv
                plan = kattn.attention_plan(dtype, hd, False)
                for n, k in (("chunk_attention", 2), ("flash_dq", 1), ("flash_dkv", 1)):
                    want[n][plan[n]] += k
        chunk_case(f"non-causal {tag} hd 80 prefill chunk (sentinel keys, 5 padded rows, "
                   f"window 30)",
                   chunk_inputs(r, dtype, b=1, c=64, prior_real=90, prior_blocks=8, blk=16,
                                h=4, kv=2, hd=80, window=30, pad_rows=5), causal=False)
        want["chunk_attention"][kattn.attention_plan(dtype, 80, False)["chunk_attention"]] += 1
    routes = attention_routes()
    if routes != want:
        raise AssertionError(f"non-causal cases: routes {routes}, expected {want}")
    print(f"  non-causal attention routes {routes} (each kernel on its planned route)")


HUBERT = get_config("hubert-xlarge")
# hubert-xlarge's training microbatch: 2 sequences of 1024 frames (20.48 s of
# 16 kHz audio at the 20 ms frame stride of HuBERT's convolutional encoder)
HUBERT_SEQ, HUBERT_MICRO = 1024, 2


def encoder_attention_records(r) -> list[dict]:
    """The chunk forward, dq and dk/dv at hubert-xlarge's training shape (B
    2, S 1024, 16 heads of hd 80, non-causal, bf16), each on its planned
    route: against the plain version, timed beside it and SDPA
    (``is_causal=False``: forward for the chunk forward, backward for dq and
    dk/dv, as the causal rows) and, for each kernel on the tensor cores,
    beside the FMA kernel at the same call (launched directly, counted
    nowhere, held against the plain version too), with two bounds: the work
    at the bf16 tensor-core rate (the record's bound) and at the float32 FMA
    rate."""
    b, s, h, hd = HUBERT_MICRO, HUBERT_SEQ, HUBERT.num_heads, HUBERT.resolved_head_dim
    inp = flash_inputs(r, torch.bfloat16, b=b, s=s, h=h, kv=h, hd=hd, causal=False)
    q, k, v, dout, lse, delta = (inp[n] for n in ("q", "k", "v", "dout", "lse", "delta"))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    ones = torch.ones_like(pos)
    fwd_err = chunk_case(f"hubert training shape bf16 (B {b}, S {s}, {h} heads of hd {hd}, "
                         f"non-causal)", dict(q=q, k=k, v=v, q_pos=pos, k_pos=pos,
                                              k_valid=ones, window=None), causal=False)
    err_dq, err_dkv = flash_case(f"hubert training shape bf16 (B {b}, S {s}, non-causal)",
                                 inp)
    kw = dict(causal=False)
    plan = kattn.attention_plan(q.dtype, hd, False)
    fwd = lambda: kattn.chunk_attention_fwd(q, k, v, pos, pos, ones, **kw)  # noqa: E731
    dq = lambda: kattn.flash_dq(q, k, v, dout, lse, delta, **kw)  # noqa: E731
    dkv = lambda: kattn.flash_dkv(q, k, v, dout, lse, delta, **kw)  # noqa: E731
    times = {name: (timed_ms(fn), timed_ms(fn, spin=True))
             for name, fn in (("fwd", fwd), ("dq", dq), ("dkv", dkv))}
    # the FMA kernels at the same call, launched directly (the private
    # launchers count no launch and take no plan)
    fma_dq = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    fma_dk = torch.empty(k.shape, dtype=torch.float32, device="cuda")
    fma_dv = torch.empty_like(fma_dk)
    fma_fwd = lambda: kattn._chunk_launch(  # noqa: E731
        "chunk_attention", q, k, v, pos, pos, ones, None, None, False)
    fma_dq_call = lambda: kattn._backward_launch(  # noqa: E731
        "flash_dq", q, k, v, dout, lse, delta, (fma_dq,), None, None, False, "flash_dq")
    fma_dkv = lambda: kattn._backward_launch(  # noqa: E731
        "flash_dkv", q, k, v, dout, lse, delta, (fma_dk, fma_dv), None, None, False,
        "flash_dkv")
    fma_out, fma_lse = fma_fwd()
    fma_dq_call()
    fma_dkv()
    torch.cuda.synchronize()
    want_out, want_lse = ref.attention_ref_lse(q, k, v, pos, pos, ones, causal=False)
    want_dq, want_dk, want_dv = ref.flash_grads_ref(q, k, v, lse, delta, dout, causal=False)
    tol = FLASH_TOL[q.dtype]
    fma_err = {"fwd": max(check("FMA forward", fma_out, want_out, q.dtype),
                          check("FMA forward lse", fma_lse, want_lse, q.dtype)),
               "dq": check("FMA dq", fma_dq, want_dq, q.dtype, tol=tol),
               "dkv": max(check("FMA dk", fma_dk, want_dk, q.dtype, tol=tol),
                          check("FMA dv", fma_dv, want_dv, q.dtype, tol=tol))}
    fma_times = {name: (timed_ms(fn), timed_ms(fn, spin=True))
                 for name, fn in (("fwd", fma_fwd), ("dq", fma_dq_call), ("dkv", fma_dkv))}
    plain_fwd = timed_ms(lambda: ref.attention_ref_lse(q, k, v, pos, pos, ones, causal=False))
    plain_bwd = timed_ms(lambda: ref.flash_grads_ref(q, k, v, lse, delta, dout, causal=False))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        sdpa_fwd = timed_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = dout.transpose(1, 2)
    sdpa_bwd = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    pairs = b * h * s * s  # every (row, key) pair over all (b, h)
    read = nbytes(q, k, v, dout, lse, delta)
    rows = []
    for name, counter, flops, moved, plain, library, err, src, line in (
            ("fwd", "chunk_attention", 4 * hd * pairs, nbytes(q, k, v, q) + b * h * s * 4,
             plain_fwd, sdpa_fwd, fwd_err, "chunk_attention", 92),
            ("dq", "flash_dq", 6 * hd * pairs, read + b * s * h * hd * 4, plain_bwd, sdpa_bwd,
             err_dq, "flash_dq", 218),
            ("dkv", "flash_dkv", 8 * hd * pairs, read + 2 * b * s * h * hd * 4, plain_bwd,
             sdpa_bwd, err_dkv, "flash_dkv", 245)):
        ms, dev = times[name]
        route = plan[counter]
        bound_ms, by = bound(moved, flops)
        fma_bound, _ = bound(moved, flops, PEAK_F32)
        rec = {"name": f"{counter} (non-causal, hd {hd})", "counter": counter,
               "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}{'_tc' if route == 'tc' else ''}.cu",
               "replaces": f"src/repro/kernels/attention.py:{line}",
               "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
               "bound_by": by, "library_ms": library, "device_ms": dev,
               "fma_bound_ms": fma_bound, "dispatch": route, "tflops": flops / ms / 1e9}
        fma = ""
        if route == "tc":
            f_ms, f_dev = fma_times[name]
            rec.update(fma_ms=f_ms, fma_device_ms=f_dev, fma_max_abs_err=fma_err[name],
                       fma_source=f"src/repro_torch/kernels/csrc/{src}.cu")
            fma = (f"; the FMA kernel at the same call {f_ms:.4f} ms ({f_dev:.4f} alone, "
                   f"{flops / f_ms / 1e9:.1f} TFLOP/s, max abs err {fma_err[name]:.3e}): "
                   f"{f_ms / ms:.1f}x the tensor cores' time")
        print(f"  {counter} at hubert's training shape (B {b}, S {s}, hd {hd}, non-causal) "
              f"[{route}]: {ms:.4f} ms ({dev:.4f} on the card alone), {flops / ms / 1e9:.1f} "
              f"TFLOP/s; plain {plain:.4f}, SDPA {library:.4f} ({ms / library:.2f}x); bound "
              f"{bound_ms:.4f} ms by {by} at 989 TFLOP/s ({100 * bound_ms / ms:.1f}% of it), "
              f"{fma_bound:.4f} ms at the float32 FMA rate{fma}")
        rows.append(rec)
    del out, qt, kt, vt, inp, fma_dq, fma_dk, fma_dv, fma_out, fma_lse
    return rows


# per-sample gradient norms: f32 and bf16 inputs, and bf16 activations with
# the float32 deltas the standalone entry point passes; products of bf16
# values are exact in float32, so every case is held at 1e-4 relative
PSGN_TOL = 1e-4
PSGN_TYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16,) * 2,
              "bf16 x f32": (torch.bfloat16, torch.float32),
              "f32 x bf16": (torch.float32, torch.bfloat16)}


def psgn_inputs(r, shape, dtypes):
    """x (..., S, Din) and delta (..., S, Dout) on the card for the shape
    (..., S, Din, Dout)."""
    *lead, s, d_in, d_out = shape
    x = torch.from_numpy(r.standard_normal((*lead, s, d_in))).to("cuda", dtypes[0])
    d = torch.from_numpy(r.standard_normal((*lead, s, d_out))).to("cuda", dtypes[1])
    return x, d


def psgn_check(name, got, want) -> tuple[float, float]:
    """(max abs err, max rel err) of a (B,) psgn result; fails over
    PSGN_TOL relative."""
    err = (got - want.float()).abs()
    rel = (err / want.float().abs()).max().item()
    if rel > PSGN_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: max rel err {rel:.3e} > {PSGN_TOL}")
    return err.max().item(), rel


def psgn_case(name, shape, dtypes, r) -> None:
    x, d = psgn_inputs(r, shape, dtypes)
    xs, ds = psgn_inputs(r, (3, *shape), dtypes)
    s, d_in, d_out = shape[1:]
    for label, kind, got, want in (
            ("direct", "direct", psgn.psgn_direct(x, d), ref.psgn_ref(x, d)),
            ("gram", "gram", psgn.psgn_gram(x, d), ref.psgn_gram_ref(x, d)),
            ("fused (L 3)", "direct", psgn.psgn_fused(xs, ds), ref.psgn_fused_ref(xs, ds))):
        torch.cuda.synchronize()
        _, rel = psgn_check(f"psgn {label} {name}", got, want)
        route = psgn.plan(kind, x.dtype, d.dtype, s, d_in, d_out).route
        print(f"  psgn {label} {name} [{route}]: max rel err {rel:.3e} (tol {PSGN_TOL}); "
              f"plain {want.min().item():.6e}..{want.max().item():.6e}")


def psgn_record(name, run, plain, library, *, err, moved, flops, peak, replaces,
                dispatch, pairs=1, floor_flops=None) -> dict:
    """A psgn kernel's record; ``dispatch`` is its route, "tc" (tensor
    cores), "split" (float32 operands split for the tensor cores) or "fma",
    which names its source.  ``flops`` is the function's, and the bound
    counts those; the split route runs ``pairs`` term pairs, ``floor_flops``
    of bf16 work (``pairs * flops`` unless given), and its own floor
    (``split_floor_ms``, at the bf16 rate) is kept beside the bound.  Adds
    the achieved TFLOP/s of the function."""
    ms, plain_ms, library_ms = timed_ms(run), timed_ms(plain), timed_ms(library)
    device_ms = timed_ms(run, spin=True)
    bound_ms, by = bound(moved, flops, peak)
    lib = "psgn_gram" if name == "psgn_gram" else "psgn_direct"
    source = f"src/repro_torch/kernels/csrc/{lib}{'' if dispatch == 'fma' else '_tc'}.cu"
    rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": by, "library_ms": library_ms, "device_ms": device_ms,
           "dispatch": dispatch, "tflops": flops / ms / 1e9}
    if dispatch == "split":
        floor_flops = pairs * flops if floor_flops is None else floor_flops
        rec["pairs"] = pairs
        rec["split_floor_ms"] = bound(moved, floor_flops, PEAK_BF16)[0]
        rec["floor_tflops"] = floor_flops / ms / 1e9
    return rec


def psgn_line(label, rec) -> None:
    floor = ""
    if "split_floor_ms" in rec:
        floor = (f"; the split design's own floor ({rec['pairs']} term pairs) "
                 f"{rec['split_floor_ms']:.4f} ms, {100 * rec['split_floor_ms'] / rec['ms']:.1f}%"
                 f" of it, {rec['floor_tflops']:.1f} TFLOP/s on the tensor cores")
    print(f"  {label} [{rec['dispatch']}]: {rec['ms']:.4f} ms ({rec['device_ms']:.4f} on the "
          f"card alone), {rec['tflops']:.1f} TFLOP/s "
          f"(plain {rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}); bound "
          f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
          f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it{floor}")


def sass_hgmma() -> None:
    """How many HGMMA (wgmma) instructions the tensor-core libraries hold,
    where the toolkit has ``cuobjdump``."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("  HGMMA in SASS: no cuobjdump beside nvcc")
        return
    counts = {}
    for name in ("psgn_direct_tc", "psgn_gram_tc", "chunk_attention_tc", "flash_dq_tc",
                 "flash_dkv_tc"):
        sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = sum("HGMMA" in line for line in sass.splitlines())
    print("  HGMMA in SASS: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if not all(counts.values()):
        raise AssertionError(f"a tensor-core library has no HGMMA: {counts}")


def split_record(d: torch.Tensor) -> dict:
    """The split of float32 ``d`` into bf16 terms, held bit for bit against
    its plain version; bound by bytes (4 read, 6 written per element), no
    library call computes it."""
    got, want = psgn.psgn_split([d]), ref.split_bf16(d)[:, None]
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("psgn_split: the terms differ from the plain version's bits")
    del got, want
    ms = timed_ms(lambda: psgn.psgn_split([d]))
    device_ms = timed_ms(lambda: psgn.psgn_split([d]), spin=True)
    plain_ms = timed_ms(lambda: ref.split_bf16(d))
    bound_ms, by = bound(nbytes(d) + 3 * 2 * d.numel(), 0.0)
    print(f"  psgn_split of the float32 deltas at q {tuple(d.shape)}: bit-exact; {ms:.4f} ms "
          f"({device_ms:.4f} on the card alone; plain {plain_ms:.4f}, no library call); "
          f"bound {bound_ms:.4f} ms by {by}, {100 * bound_ms / ms:.1f}% of it")
    return {"name": "psgn_split", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psgn_split.cu",
            "replaces": "src/repro/kernels/psgn.py:65", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "device_ms": device_ms}


def gram_split_record(r, shape, tag) -> None:
    """gram at ``shape`` (B, S, Din, Dout) with a float32 operand (``tag``
    names the pair): the split route, each float32 operand's Gram 6
    term-pair products on the tensor cores, held against the plain Gram and
    the split's plain version, timed beside the plain version, two bmm and
    the FMA kernel at the same call (launched directly, counted nowhere).
    The bound counts the function's products at the bf16 rate, the floor
    the split's."""
    b, s, d, f = shape
    x, dl = psgn_inputs(r, shape, PSGN_TYPES[tag])
    got, want = psgn.psgn_gram(x, dl), ref.psgn_gram_ref(x, dl)
    err, rel = psgn_check(f"psgn_gram slice {tag}", got, want)
    _, rel_split = psgn_check(f"psgn_gram slice {tag} against the split's plain version", got,
                              ref.psgn_gram_split_ref(x, dl))
    print(f"  psgn_gram slice {tag} (B {b}, S {s}, {d} -> {f}): max rel err {rel:.3e}, "
          f"{rel_split:.3e} against the split route's plain version; plain "
          f"{want.min().item():.6e}..{want.max().item():.6e}")
    p = psgn.plan("gram", x.dtype, dl.dtype, s, d, f)
    rec = psgn_record(
        "psgn_gram", lambda: psgn.psgn_gram(x, dl), lambda: ref.psgn_gram_ref(x, dl),
        lambda: (torch.bmm(x.float(), x.float().mT) * torch.bmm(dl.float(), dl.float().mT))
        .sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=b * s * (s + 1) * (d + f),
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:129", dispatch=p.route,
        pairs=p.pairs, floor_flops=b * s * (s + 1) * (p.pairs[0] * d + p.pairs[1] * f))
    # one partial per 128 x 128 tile pair i <= j
    n_t = -(-s // psgn.TILE)
    fma_gram = lambda: psgn._fma_launch(  # noqa: E731
        "psgn_gram", x, dl, (b, s, d, f), n_t * (n_t + 1) // 2)
    fma_got = fma_gram()
    torch.cuda.synchronize()
    _, fma_rel = psgn_check(f"psgn_gram FMA slice {tag}", fma_got, want)
    fma_ms, fma_dev = timed_ms(fma_gram), timed_ms(fma_gram, spin=True)
    rec.update(fma_ms=fma_ms, fma_device_ms=fma_dev,
               fma_bound_ms=bound(nbytes(x, dl) + 4 * b, b * s * (s + 1) * (d + f),
                                  PEAK_F32)[0])
    psgn_line(f"psgn_gram at gate/up, {tag} ({d} -> {f}, {p.pairs} term pairs)", rec)
    print(f"  psgn_gram at gate/up, {tag}: the FMA kernel at the same call {fma_ms:.4f} ms "
          f"({fma_dev:.4f} alone, max rel err {fma_rel:.3e}, bound "
          f"{rec['fma_bound_ms']:.4f} ms at the float32 FMA rate): "
          f"{fma_ms / rec['ms']:.2f}x the split route's time; the split route "
          f"{rec['ms'] / rec['library_ms']:.2f}x the library call")
    del x, dl, fma_got


def psgn_kernel_records(r) -> list[dict]:
    """The gram tier's launches at Yi-6B widths, B 2, S 2048: fused over the
    16 q/o layers (the record) and the 16 k/v layers, gram at gate/up
    (4096 -> 11008), direct at q as the standalone entry point calls it (bf16
    activations, float32 deltas: the split route, and the split itself);
    then, printed beside them, direct at q with float32 activations too (6
    term pairs) and gram at gate/up with float32 deltas (the standalone
    entry point's form) and in float32 (the split route, beside the FMA
    kernel)."""
    b, s, d, f = 2, 2048, YI.d_model, YI.d_ff
    kv = YI.num_kv_heads * YI.resolved_head_dim
    bf16 = PSGN_TYPES["bf16"]

    def fused_case(d_out):
        xs, ds = psgn_inputs(r, (16, b, s, d, d_out), bf16)
        got = psgn.psgn_fused(xs, ds)
        want = ref.psgn_fused_ref(xs, ds)
        err, rel = psgn_check(f"psgn_fused slice (L 16, {d} -> {d_out})", got, want)
        print(f"  psgn_fused slice bf16 (L 16, B {b}, S {s}, {d} -> {d_out}): max rel err "
              f"{rel:.3e}; plain {want.min().item():.6e}..{want.max().item():.6e}")
        rec = psgn_record(
            "psgn_fused", lambda: psgn.psgn_fused(xs, ds), lambda: ref.psgn_fused_ref(xs, ds),
            lambda: torch.bmm(xs.flatten(0, 1).mT, ds.flatten(0, 1)).float().square()
            .sum((1, 2)).view(16, b).sum(0),
            err=err, moved=nbytes(xs, ds) + 4 * b, flops=2 * 16 * b * s * d * d_out,
            peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:182",
            dispatch=psgn.plan("direct", xs.dtype, ds.dtype, s, d, d_out, 16).route)
        # the layer table the gram tier launches: the same bits as the stack
        table = psgn.psgn_fused_layers(list(xs), list(ds))
        if not torch.equal(table, got):
            raise AssertionError(f"psgn_fused_layers {table.tolist()} != stacked {got.tolist()}")
        del xs, ds
        return rec

    fused = fused_case(d)
    psgn_line(f"psgn_fused at the q/o group (L 16, {d} -> {d})", fused)
    fused_kv = fused_case(kv)
    psgn_line(f"psgn_fused at the k/v group (L 16, {d} -> {kv})", fused_kv)

    x, dl = psgn_inputs(r, (b, s, d, f), bf16)
    got, want = psgn.psgn_gram(x, dl), ref.psgn_gram_ref(x, dl)
    err, rel = psgn_check("psgn_gram slice", got, want)
    print(f"  psgn_gram slice bf16 (B {b}, S {s}, {d} -> {f}): max rel err {rel:.3e}; "
          f"plain {want.min().item():.6e}..{want.max().item():.6e}")
    # the kernel forms the upper triangle of both Gram matrices: S(S+1)/2
    # position pairs, a multiply-add per feature of each
    gram = psgn_record(
        "psgn_gram", lambda: psgn.psgn_gram(x, dl), lambda: ref.psgn_gram_ref(x, dl),
        lambda: (torch.bmm(x, x.mT) * torch.bmm(dl, dl.mT)).sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=b * s * (s + 1) * (d + f),
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:129",
        dispatch=psgn.plan("gram", x.dtype, dl.dtype, s, d, f).route)
    psgn_line(f"psgn_gram at gate/up ({d} -> {f})", gram)
    del x, dl

    x, dl = psgn_inputs(r, (b, s, d, d), PSGN_TYPES["bf16 x f32"])
    got, want = psgn.psgn_direct(x, dl), ref.psgn_ref(x, dl)
    err, rel = psgn_check("psgn_direct slice", got, want)
    print(f"  psgn_direct slice bf16 x f32 (B {b}, S {s}, {d} -> {d}): max rel err "
          f"{rel:.3e}; plain {want.min().item():.6e}..{want.max().item():.6e}")
    # the split route: T products of bf16 terms on the tensor cores; the
    # bound counts the function's one product at the bf16 rate
    p = psgn.plan("direct", x.dtype, dl.dtype, s, d, d)
    direct = psgn_record(
        "psgn_direct", lambda: psgn.psgn_direct(x, dl), lambda: ref.psgn_ref(x, dl),
        lambda: torch.bmm(x.float().mT, dl).square().sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=2 * b * s * d * d,
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:65", dispatch=p.route,
        pairs=p.pairs)
    psgn_line(f"psgn_direct at q, float32 deltas ({d} -> {d}, {p.pairs} term pairs)", direct)
    print(f"  psgn_direct at q, float32 deltas: peak device memory above its inputs "
          f"{1024 * peak_gib(lambda: psgn.psgn_direct(x, dl)):.1f} MiB (the split terms "
          f"{3 * 2 * dl.numel() / 2**20:.1f} MiB)")
    split = split_record(dl)
    del x, dl

    x, dl = psgn_inputs(r, (b, s, d, d), PSGN_TYPES["f32"])
    got, want = psgn.psgn_direct(x, dl), ref.psgn_ref(x, dl)
    err, rel = psgn_check("psgn_direct slice f32", got, want)
    p = psgn.plan("direct", x.dtype, dl.dtype, s, d, d)
    both = psgn_record(
        "psgn_direct", lambda: psgn.psgn_direct(x, dl), lambda: ref.psgn_ref(x, dl),
        lambda: torch.bmm(x.mT, dl).square().sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=2 * b * s * d * d,
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:65", dispatch=p.route,
        pairs=p.pairs)
    print(f"  psgn_direct slice f32 x f32: max rel err {rel:.3e}; plain "
          f"{want.min().item():.6e}..{want.max().item():.6e}")
    psgn_line(f"psgn_direct at q, float32 x and deltas ({d} -> {d}, {p.pairs} term pairs)",
              both)
    del x, dl

    for tag in ("bf16 x f32", "f32"):
        gram_split_record(r, (b, s, d, f), tag)
    torch.cuda.empty_cache()
    return [direct, split, gram, fused]


def quant_cases(r) -> dict:
    """The int8 quantisation's edge cases (float32 values): rows not a
    multiple of a 256-row block, C of 1 and ragged, a row over several
    4096-element chunks, an all-zero row, exact .5 ties, rows whose absmax
    is a negative entry, rows holding a NaN or an infinity (a NaN or
    infinite scale, every code 0); and the pod slice's four MLP leaves as
    one row."""
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]],
                    np.float32)
    neg = r.uniform(-1, 1, (6, 50)).astype(np.float32)
    neg[np.arange(6), r.integers(0, 50, 6)] = -np.arange(2, 8, dtype=np.float32)
    zero = r.standard_normal((5, 40)).astype(np.float32)
    zero[2] = 0.0
    bad = r.standard_normal((5, 4099)).astype(np.float32)
    bad[0, 7], bad[1, 4098], bad[2, 901] = np.nan, np.inf, -np.inf
    bad[3, [1, 4097]] = np.inf, np.nan
    mlp = {f"MLP leaf {shape}": (r.standard_normal((1, int(np.prod(shape)))) * 0.01)
           .astype(np.float32) for shape in ((POD_HIDDEN, POD_D), (POD_HIDDEN,),
                                             (1, POD_HIDDEN), (1,))}
    return {"ragged rows (300, 64)": r.standard_normal((300, 64)).astype(np.float32) * 3,
            "C 1 (7, 1)": r.standard_normal((7, 1)).astype(np.float32),
            "ragged C (33, 4099)": r.standard_normal((33, 4099)).astype(np.float32),
            "one row over 3 chunks + 5": r.standard_normal((1, 3 * 4096 + 5)).astype(np.float32),
            "zero row": zero, "ties": np.concatenate([ties, 2 * ties, ties / 4]),
            "negative max": neg, "NaN and inf rows": bad, **mlp}


def quant_design_cases(flat: torch.Tensor) -> dict:
    """The kernel's two designs at their edges, views of ``flat`` (131072
    values): the one-pass design's longest row (32768) and one either side,
    rows of it, views at an offset of 1 element (no 16-byte aligned
    element) and of 8 (a head before each row's first aligned unit), in
    either design, and ragged rows over the two-pass design."""
    return {"the one-pass design's longest row (1, 32768)": flat[:32768].reshape(1, -1),
            "one less (1, 32767)": flat[:32767].reshape(1, -1),
            "one more: two passes (1, 32769)": flat[:32769].reshape(1, -1),
            "rows at the threshold (4, 32768)": flat.reshape(4, -1),
            "a view at 1 element (1, 32000)": flat[1:32001].reshape(1, -1),
            "a view at 8 elements (5, 13105)": flat[8:65533].reshape(5, -1),
            "a view at 1 element, two passes (1, 65530)": flat[1:65531].reshape(1, -1),
            "a view at 8 elements, two passes (2, 50001)": flat[8:100010].reshape(2, -1),
            "ragged two-pass rows (3, 40001)": flat[:120003].reshape(3, -1)}


def same_scales(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal scales, a NaN counting as equal to a NaN in the same row."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def quant_case(name: str, x: torch.Tensor) -> float:
    """The kernel against its plain version: codes and scales EQUAL.
    Returns the largest difference of either (0.0)."""
    q, s = quant.quantize_int8(x)
    torch.cuda.synchronize()
    want_q, want_s = ref.quantize_int8(x)
    flipped = int((q != want_q).sum())
    if flipped or not same_scales(s, want_s):
        raise AssertionError(f"quantize_int8 {name} {x.dtype}: {flipped} codes and "
                             f"{int((s != want_s).sum())} scales differ")
    tag = "f32" if x.dtype == torch.float32 else "bf16"
    finite = want_s.isfinite()
    print(f"  quantize_int8 {tag} {name}: codes and scales bit-exact ({q.numel()} codes"
          + (f"; {int((~finite).sum())} rows with NaN or infinite scales on both"
             if not finite.all() else "") + ")")
    return max((q.int() - want_q.int()).abs().max().item(),
               (s[finite] - want_s[finite]).abs().max().item())


def quant_library(x: torch.Tensor):
    """The library yardstick: amax, divide, round, clamp, cast (timed only)."""
    s = torch.amax(x.abs(), 1).float().clamp_min(1e-12) / 127.0
    return torch.round(x / s[:, None]).clamp(-127, 127).to(torch.int8), s


L2_BYTES = 50e6
#: the longest row ``csrc/quant_int8.cu`` quantises in one pass
ONE_PASS_ROW = 32768


def quant_kernel_record() -> dict:
    """Yi-6B-width gradient leaves: the gate weight per tensor (1, 4096 x
    11008) in float32 (the record: the compressor views a leaf as one row),
    and rowwise (11008, 4096) in float32 and bf16; then the pod slice's
    largest leaf.  Each with its design, the bound (x read once) and, where
    a row outgrows the L2, the floor of a design that reads x twice."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, dtype in (((1, YI.d_model * YI.d_ff), torch.float32),
                         ((YI.d_ff, YI.d_model), torch.float32),
                         ((YI.d_ff, YI.d_model), torch.bfloat16),
                         ((1, POD_HIDDEN * POD_D), torch.float32)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
        err = quant_case(f"Yi-6B leaf {shape}" if shape[1] != POD_HIDDEN * POD_D
                         else f"pod leaf {shape}", x)
        ms = timed_ms(lambda: quant.quantize_int8(x))
        device_ms = timed_ms(lambda: quant.quantize_int8(x), spin=True)
        plain_ms = timed_ms(lambda: ref.quantize_int8(x))
        library_ms = timed_ms(lambda: quant_library(x))
        # x read once, the codes and the scales written once
        bound_ms, by = bound(nbytes(x) + x.numel() + 4 * shape[0], 0.0)
        row_bytes = nbytes(x) // shape[0]
        floor = (f"; two-read floor {1e3 * (2 * nbytes(x) + x.numel()) / PEAK_BYTES:.4f} ms "
                 f"(a row of {row_bytes / 1e6:.1f} MB outgrows the L2)"
                 if row_bytes > L2_BYTES else "")
        tag = "f32" if dtype == torch.float32 else "bf16"
        design = "one pass" if shape[1] <= ONE_PASS_ROW else "two passes"
        print(f"  quantize_int8 {tag} {shape} [{design}]: {ms:.4f} ms ({device_ms:.4f} on the "
              f"card alone; plain {plain_ms:.4f}, library {library_ms:.4f}); bound "
              f"{bound_ms:.4f} ms by {by}, {100 * bound_ms / ms:.1f}% of it ("
              f"{100 * bound_ms / device_ms:.1f}% alone){floor}")
        rows.append((err, ms, device_ms, plain_ms, library_ms, bound_ms, by))
        del x
    err, ms, device_ms, plain_ms, library_ms, bound_ms, by = rows[0]
    return {"name": "quantize_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quant_int8.cu",
            "replaces": "src/repro/kernels/quant.py:20", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "device_ms": device_ms}


def kernels_phase() -> list[dict]:
    phase("3. kernels against their plain versions (TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        chunk_case(f"{tag} n_rep 1, softcap 30, ragged C 23 / Sk 71",
                   chunk_inputs(r, dtype, b=2, c=23, prior_real=40, prior_blocks=3,
                                blk=16, h=4, kv=4, hd=64), softcap=30.0)
        chunk_case(f"{tag} n_rep 8, window 6, padded rows at -(2**30)",
                   chunk_inputs(r, dtype, b=1, c=37, prior_real=20, prior_blocks=2,
                                blk=16, h=8, kv=1, hd=128, window=6, pad_rows=5))
        chunk_case(f"{tag} hd 32, no prior",
                   chunk_inputs(r, dtype, b=1, c=9, prior_real=0, prior_blocks=0,
                                blk=16, h=4, kv=2, hd=32))
        decode_case(f"{tag} n_rep 1, softcap 10",
                    decode_inputs(r, dtype, b=5, blk=8, n_max=6, nb=40, kv=4, h=4,
                                  hd=64, max_len=48), softcap=10.0)
        decode_case(f"{tag} n_rep 8",
                    decode_inputs(r, dtype, b=3, blk=16, n_max=5, nb=20, kv=2, h=16,
                                  hd=128, max_len=80))
        decode_case(f"{tag} hd 80 (a thread's outputs over several columns)",
                    decode_inputs(r, dtype, b=3, blk=16, n_max=5, nb=20, kv=2, h=4,
                                  hd=80, max_len=80))
        flash_case(f"{tag} ragged S 37, n_rep 1, softcap 30",
                   flash_inputs(r, dtype, b=2, s=37, h=4, kv=4, hd=64, softcap=30.0))
        flash_case(f"{tag} ragged S 300, n_rep 8",
                   flash_inputs(r, dtype, b=1, s=300, h=16, kv=2, hd=128))
        flash_case(f"{tag} window 40 across tiles, softcap 20",
                   flash_inputs(r, dtype, b=1, s=150, h=8, kv=2, hd=128, window=40,
                                softcap=20.0))
        flash_case(f"{tag} a single tile (S 16), hd 32",
                   flash_inputs(r, dtype, b=2, s=16, h=4, kv=2, hd=32))
    tc_attention_cases(r)
    noncausal_cases(r)
    decode_split_cases(r)
    dense_serving_cases(r)
    gemma_train_attention_case(r)
    moe_attention_cases(r)
    torch.cuda.empty_cache()
    for tag, dtypes in PSGN_TYPES.items():
        for shape in ((1, 37, 19, 23), (4, 33, 7, 130), (1, 300, 130, 260),
                      (2, 129, 257, 129), (3, 1, 5, 9)):
            psgn_case(f"{tag} (B, S, Din, Dout) {shape}", shape, dtypes, r)
    # the tensor-core route: bf16, widths multiples of 8 at the FMA cases'
    # edges, ragged 64-position stages and 128-position tiles, ragged
    # 128- and 256-wide tiles, one box
    for shape in ((1, 37, 24, 24), (4, 33, 8, 136), (1, 300, 136, 264),
                  (2, 129, 264, 136), (3, 1, 8, 16), (2, 2049, 4104, 264)):
        psgn_case(f"bf16 (B, S, Din, Dout) {shape}", shape, PSGN_TYPES["bf16"], r)
    # the split route: a float32 operand at widths that are multiples of 8
    for tag in ("bf16 x f32", "f32 x bf16", "f32"):
        for shape in ((1, 37, 24, 24), (4, 33, 8, 136), (1, 300, 136, 264), (3, 1, 8, 16),
                      (2, 2049, 4104, 264)):
            psgn_case(f"{tag} (B, S, Din, Dout) {shape}", shape, PSGN_TYPES[tag], r)
    sass_hgmma()
    for dtype in (torch.float32, torch.bfloat16):
        for name, x32 in quant_cases(r).items():
            quant_case(name, torch.from_numpy(x32).to("cuda", dtype))
        flat = torch.from_numpy(r.standard_normal(1 << 17).astype(np.float32)).to("cuda", dtype)
        for name, x in quant_design_cases(flat).items():
            quant_case(name, x)
    records = [chunk_kernel_record(r), decode_kernel_record(r), *flash_kernel_records(r),
               *encoder_attention_records(r), *psgn_kernel_records(r), quant_kernel_record(),
               *dense_kernel_records(r), *moe_kernel_records(r), *mamba_kernel_records(r),
               *tp_serve_kernel_records(r)]
    torch.cuda.empty_cache()
    for rec in records:
        lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
        print(f"  {rec['name']}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
              f"library {lib}); bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']}, {100 * rec['bound_ms'] / rec['ms']:.1f}% of it")
    return records


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------


def slice_requests(vocab: int, seed: int = 0):
    """8 prompts of 64-700 tokens; the last two share their first 256 real
    tokens (and, at one length, their left padding), so the second adopts
    the first's registered blocks."""
    r = np.random.default_rng(seed)
    prefix = r.integers(1, vocab, size=256)
    lens = [64, 700, 150, 333, 96, 512]
    reqs = [r.integers(1, vocab, size=n) for n in lens]
    reqs += [np.concatenate([prefix, r.integers(1, vocab, size=144)]) for _ in range(2)]
    return [Request(prompt=p.astype(np.int32), max_new_tokens=32) for p in reqs]


def pool_bytes(engine: ServeEngine) -> int:
    return sum(x.numel() * x.element_size() for leaf in engine._pages.values()
               for x in leaf.values())


def pool_gib(engine: ServeEngine) -> float:
    return pool_bytes(engine) / 2**30


#: phase 4's engine settings, which phase 31 serves at on its ranks
SLICE_KW = dict(max_slots=8, max_seq=2048, block_size=16, prompt_granule=16,
                prefill_chunk=256, prefix_sharing=True)
#: phase 31's one-process reference (phase 4's run) and its ranks' results
PHASE31: dict = {}


def slice_trace(engine: ServeEngine, reqs, step) -> list[int]:
    """Phase 4's arrivals: all but the last request up front, the last once
    the one before it decodes (its prompt is registered by then, so a
    prompt sharing its prefix, or repeating it, adopts its blocks);
    ``step()`` advances the engine and says whether work remains.  Returns
    the request ids in submit order."""
    rids = [engine.submit(q) for q in reqs[:-1]]
    sharer = rids[-1]
    while sharer not in {rid for _, rid in engine.sched.running_slots()}:
        step()
    rids.append(engine.submit(reqs[-1]))
    while step():
        pass
    return rids


def record_samples(engine: ServeEngine, into: dict) -> None:
    """Wrap ``engine._sample`` to keep, per (request, position), the gap
    between the top two logits (kept on the card, ``sample_gaps`` reads
    them; a rank samples the rows it speaks for), and ``_finish_job`` to
    keep each prefilled request's first logits (the prompt's last
    position; every rank computes them)."""
    sample_fn, finish_fn = engine._sample, engine._finish_job
    into.update(gaps=[], first={})

    def sample(logits, rids, pos):
        top = torch.topk(logits[:, -1, :].float(), 2, dim=-1).values
        into["gaps"].append(([int(x) for x in rids], [int(x) for x in pos], top))
        return sample_fn(logits, rids, pos)

    def finish(job, tok, logits):
        into["first"][job.rid] = logits[0, -1].float().cpu().numpy()
        return finish_fn(job, tok, logits)

    engine._sample, engine._finish_job = sample, finish


def sample_gaps(rec: dict) -> dict[tuple[int, int], tuple[float, float]]:
    """``{(request id, position): (top logit, top-two gap in bf16 ulps of
    the top logit)}`` of ``record_samples``: the logits are bf16 products
    cast to float32, so a gap of a few ulps is what two summation orders
    can turn over."""
    out = {}
    for rids, pos, top in rec["gaps"]:
        for rid, p, (a, b) in zip(rids, pos, top.cpu().tolist()):
            if rid >= 0:
                ulp = 2.0 ** (math.floor(math.log2(abs(a))) - 7) if a else 2.0 ** -133
                out[(rid, p)] = (a, (a - b) / ulp)
    return out


def serve_checked(cfg, params, reqs, samples: dict | None = None, **engine_kw) -> dict:
    """Serve ``reqs`` on the card through ``ServeEngine(cfg, params,
    **engine_kw)`` in ``slice_trace``'s order.  The launch counts are set
    to 0 just before and read just after; every logit must be finite.
    ``samples``: filled by ``record_samples``.  Returns the engine, counts,
    results, per-step (seconds, chunks run, decoded) records, wall seconds
    and peak GiB."""
    engine = ServeEngine(cfg, params, device="cuda", **engine_kw)
    if samples is not None:
        record_samples(engine, samples)
    print(f"  pool: {engine.pool.num_blocks} blocks of {engine.block_size} tokens, "
          f"{pool_gib(engine):.2f} GiB")

    # no logits may be NaN: flag them on the device, read once at the end
    nan_flags = []
    orig_decode, orig_chunk = tf.decode_step, tf.prefill_chunk

    def decode_checked(*a, **kw):
        out = orig_decode(*a, **kw)
        nan_flags.append(torch.isnan(out[0]).any())
        return out

    def chunk_checked(*a, **kw):
        out = orig_chunk(*a, **kw)
        nan_flags.append(torch.isnan(out[0]).any())
        return out

    tf.decode_step, tf.prefill_chunk = decode_checked, chunk_checked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t_start = time.perf_counter()
        steps = []  # (seconds, chunks run, decoded?) per engine step

        def step():
            c0, s0 = engine.stats.prefill_chunks, engine.stats.steps
            t = time.perf_counter()
            more = engine.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, engine.stats.prefill_chunks - c0,
                          engine.stats.steps - s0))
            return more

        rids = slice_trace(engine, reqs, step)
        engine.pool.check()
        wall = time.perf_counter() - t_start
        counts = kernels.launch_counts()
    finally:
        tf.decode_step, tf.prefill_chunk = orig_decode, orig_chunk
    results = [engine.result(rid) for rid in rids]
    if any(bool(f) for f in nan_flags):
        raise AssertionError("NaN logits on the full-width path")
    if [len(res.tokens) for res in results] != [q.max_new_tokens for q in reqs]:
        raise AssertionError(f"unfinished requests: {[len(x.tokens) for x in results]}")
    return {"engine": engine, "counts": counts, "results": results, "steps": steps,
            "wall": wall, "peak": torch.cuda.max_memory_allocated() / 2**30}


def serve_report(out: dict, cfg, reqs, *, per_chunk: int, per_step: int) -> dict:
    """Hold the launches of a ``serve_checked`` run to exactly ``per_chunk``
    chunk launches per prefill chunk and ``per_step`` paged decode launches
    per decode step, every chunk on its planned route, and print the run:
    launches, decode step and prefill chunk ms, tokens/s, peak memory,
    stats.  Returns the decode and chunk medians in ms."""
    st, counts, steps = out["engine"].stats, out["counts"], out["steps"]
    want = {"chunk_attention": st.prefill_chunks * per_chunk,
            "paged_decode_attention": st.steps * per_step,
            "flash_dq": 0, "flash_dkv": 0, **NO_PSGN}
    if counts != want or 0 in (want["chunk_attention"], want["paged_decode_attention"]):
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="serving")
    decode_ms, chunk_ms, n_dec, n_chunk = step_medians(steps)
    print(f"  launches: {counts} (= {per_chunk} x {st.prefill_chunks} chunks, "
          f"{per_step} x {st.steps} decode steps, no backward); attention routes "
          f"{attention_routes()}; the last decode step's plan "
          f"{kattn.paged_decode_attention.splits} splits")
    print(f"  decode step: median {decode_ms:.2f} ms over {n_dec} "
          f"decode-only steps (batch bucket {st.buckets})")
    print(f"  prefill chunk: median {chunk_ms:.2f} ms over "
          f"{n_chunk} steps with chunks (decode share subtracted)")
    print(f"  end to end: {st.tokens} tokens in {out['wall']:.2f} s = "
          f"{st.tokens / out['wall']:.1f} tokens/s; prompt tokens "
          f"{sum(len(q.prompt) for q in reqs)}")
    print(f"  peak device memory: {out['peak']:.2f} GiB")
    print(f"  stats: {json.dumps(st.as_dict())}")
    print(f"  first request's tokens: {out['results'][0].tokens.tolist()[:12]} ...")
    return {"decode_ms": decode_ms, "chunk_ms": chunk_ms}


def step_medians(steps) -> tuple[float, float, int, int]:
    """From ``serve_checked``'s step records: the median decode-only step
    and the median prefill chunk (the step's decode share subtracted), in
    ms, and their counts."""
    decode_only = [s for s, c, d in steps if c == 0 and d == 1]
    decode_ms = 1e3 * statistics.median(decode_only)
    chunk_ms = [1e3 * (s - (decode_ms / 1e3 if d else 0.0)) / c for s, c, d in steps if c > 0]
    return decode_ms, statistics.median(chunk_ms), len(decode_only), len(chunk_ms)


def meta_bytes(cfg) -> int:
    """The bytes of ``cfg``'s bf16 weights, counted on the meta device."""
    with torch.device("meta"):
        return nbytes(*tf.Transformer(cfg, torch.bfloat16).parameters())


def full_width_phase() -> dict:
    phase("4. Yi-6B, 32 layers, bf16, served through repro_torch.serve.ServeEngine")
    cfg = YI
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  init: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.2f} s")
    reqs = slice_requests(cfg.vocab_size)
    samples: dict = {}
    out = serve_checked(cfg, params, reqs, samples, **SLICE_KW)
    if out["engine"].stats.shared_blocks == 0:
        raise AssertionError("the shared prefix was not adopted")
    med = serve_report(out, cfg, reqs, per_chunk=cfg.num_layers, per_step=cfg.num_layers)
    # phase 31's one-process reference: the tokens, the top-two gaps, the
    # first logits, the pool's bytes
    PHASE31["want"] = {"tokens": [res.tokens.tolist() for res in out["results"]],
                       "gaps": sample_gaps(samples), "first": samples["first"],
                       "pool_bytes": pool_bytes(out["engine"]), **med}
    counts = out["counts"]
    del out, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------


def card_vs_cpu_phase() -> None:
    phase("5. reduced Yi-6B, float32: card (kernels) against CPU (plain versions)")
    cfg = get_config("yi-6b", reduced=True).replace(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512)
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    # first logits: one whole-prompt chunk into fresh pools on both devices
    r = np.random.default_rng(9)
    toks = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(1, 48)))
    logits = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        pages = tf.init_pages(cfg, 8, 16, device=dev)
        row = {"len": torch.zeros(1, dtype=torch.int32, device=dev)}
        out, _, _ = tf.prefill_chunk(cfg, model, row, pages, {"tokens": toks.to(dev)},
                                     0, torch.zeros(0, dtype=torch.long, device=dev),
                                     torch.arange(1, 4, device=dev))
        logits[dev] = out.cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"first logits differ by {err:.3e} > 1e-4")
    reqs = [Request(prompt=r.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=12) for n in (7, 40, 23, 64)]
    kw = dict(max_slots=4, max_seq=128, block_size=16, prompt_granule=16,
              prefill_chunk=32)
    kernels.reset_launch_counts()
    out_card = ServeEngine(cfg, card, device="cuda", **kw).generate(reqs)
    launched = kernels.launch_counts()
    out_cpu = ServeEngine(cfg, cpu, device="cpu", **kw).generate(reqs)
    tc = [o.tokens.tolist() for o in out_card]
    if tc != [o.tokens.tolist() for o in out_cpu]:
        raise AssertionError("card and CPU tokens differ")
    if not (launched["chunk_attention"] and launched["paged_decode_attention"]):
        raise AssertionError(f"the card run did not use the kernels: {launched}")
    attn_routes(launched, plan_of(cfg, torch.float32), what="float32 serving")
    print(f"  first logits max abs diff {err:.3e} (tol 1e-4); tokens identical "
          f"over {sum(len(t) for t in tc)} tokens; card launches {launched}")


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_LR = 8, 2048, 2, 12, 0.02
# phase 12a's depth: half of phase 6's, so that the whole script keeps inside
# its time limit (its two checkpoints and the restore scale with the depth)
CKPT_LAYERS = 4
#: median step ms by batch of each tier on this cut: phases 6, 8 and 23
TIER_MS: dict[str, dict[int, float]] = {}


def train_phase() -> dict:
    phase(f"6. Yi-6B widths, {TRAIN_LAYERS} of 32 layers, bf16, remat: DiveBatch "
          f"training through repro_torch.train.StepEngine.for_lm")
    cfg = YI.replace(num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_matmul = n_params - params.embed.weight.numel()  # the lookup does no products
    print(f"  init: {n_params / 1e9:.3f} B parameters ({n_matmul / 1e9:.3f} B in "
          f"matrix products) in {time.perf_counter() - t0:.2f} s")
    program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                    granule=TRAIN_MICRO, lr=TRAIN_LR, tick_every=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                         micro_batch=TRAIN_MICRO, attn_impl="pallas",
                         log=lambda line: print("  " + line))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    recs = out["records"]
    for rec in recs:
        print(f"  step {rec['step']:2d}: batch {rec['batch']:2d} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms")
    for rec in recs:
        if "diversity" in rec:
            print(f"  tick at step {rec['step']}: Delta {rec['diversity']:.6f}, gns "
                  f"{rec['gns']:.6g}, batch {rec['batch']} -> {rec['next_batch']}")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="training")
    print(f"  launches: {counts} (= {2 * layers}, {layers}, {layers} x {n_micro} "
          f"microbatches); attention routes {attention_routes()}")
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2

    def model_flops(batch: int) -> float:
        # 6 N per token for the products, plus causal attention: 2 products
        # forward and 4 backward of 2 * hd per (row, key) pair per head
        return (6 * n_matmul * batch * TRAIN_SEQ
                + 12 * hd * h * layers * batch * pairs)

    steady = recs[1:]
    secs = [rec["seconds"] for rec in steady]
    TIER_MS["moment"] = step_ms_by_batch(recs)
    flops = [model_flops(rec["batch"]) for rec in steady]
    tokens = [rec["batch"] * TRAIN_SEQ for rec in steady]
    print(f"  per-step ms: median {1e3 * statistics.median(secs):.1f} over steps 2-"
          f"{TRAIN_STEPS}; by batch: " + ", ".join(
              f"{m}: {1e3 * statistics.median([x['seconds'] for x in steady if x['batch'] == m]):.1f}"
              for m in sorted({x['batch'] for x in steady})))
    print(f"  tokens/s: {sum(tokens) / sum(secs):.1f} over steps 2-{TRAIN_STEPS}")
    print(f"  model FLOPs per step: " + ", ".join(
        f"batch {m}: {model_flops(m):.4e}" for m in sorted({x['batch'] for x in steady}))
          + f"; achieved {sum(flops) / sum(secs) / 1e12:.2f} TFLOP/s = "
          f"{100 * sum(flops) / sum(secs) / PEAK_BF16:.2f}% of 989 TFLOP/s")
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  stats: {json.dumps(out['engine'].stats.as_dict())}")
    del out, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 7: training, card against CPU
# ---------------------------------------------------------------------------


def train_card_vs_cpu_phase() -> None:
    phase("7. reduced Yi-6B, float32: training on the card (kernels) against the CPU "
          "(plain versions), widened to hd 64, then the reference's reduced config (hd 16)")
    reduced = get_config("yi-6b", reduced=True)
    for cfg in (reduced.replace(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                                d_ff=512, remat=True, attn_impl="pallas"),
                reduced.replace(attn_impl="pallas")):
        print(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}:")
        lm_train_card_vs_cpu(cfg)


def lm_train_card_vs_cpu(cfg, moe_groups: int = 1, lr: float = 0.05) -> None:
    """6 DiveBatch steps of ``cfg`` (float32) at ``lr`` on the card and on the CPU from
    identical weights: losses (and a MoE model's ``moe_aux``, routed in
    ``moe_groups`` groups) and parameters within 1e-4, one schedule; the
    attention kernels launched on the card (none for an attention-free
    model), none on the CPU."""
    has_attn = any(kind != "mamba" for kind in cfg.pattern)
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                        granule=2, lr=lr, tick_every=2)
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, model, program, steps=6, seq_len=64, micro_batch=2,
                             attn_impl="pallas", moe_groups=moe_groups, log=lambda line: None)
        runs[dev] = (out, kernels.launch_counts())
        if dev == "cuda" and has_attn:
            attn_routes(runs[dev][1], plan_of(cfg, torch.float32), what="float32 training")
    (card_out, card_counts), (cpu_out, cpu_counts) = runs["cuda"], runs["cpu"]
    losses = {d: np.array([x["loss"] for x in o["records"]]) for d, (o, _) in runs.items()}
    rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    if rel > 1e-4:
        raise AssertionError(f"losses differ by {rel:.3e} relative > 1e-4: {losses}")
    aux_rel = None
    if cfg.num_experts:
        aux = {d: np.array([x["moe_aux"] for x in o["records"]]) for d, (o, _) in runs.items()}
        aux_rel = float(np.max(np.abs(aux["cuda"] - aux["cpu"]) / np.abs(aux["cpu"])))
        if aux_rel > 1e-4:
            raise AssertionError(f"moe_aux differs by {aux_rel:.3e} relative > 1e-4: {aux}")
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    if err > 1e-4:
        raise AssertionError(f"parameters differ by {err:.3e} > 1e-4")
    sched = {d: [x["batch"] for x in o["records"]] for d, (o, _) in runs.items()}
    buckets = {d: o["engine"].stats.buckets for d, (o, _) in runs.items()}
    if sched["cuda"] != sched["cpu"] or buckets["cuda"] != buckets["cpu"]:
        raise AssertionError(f"batch schedules {sched} / buckets {buckets} differ")
    if any((card_counts[k] == 0) == has_attn
           for k in ("chunk_attention", "flash_dq", "flash_dkv")) or any(cpu_counts.values()):
        raise AssertionError(f"launches: card {card_counts}, CPU {cpu_counts}")
    aux_line = (f"moe_aux ({moe_groups} groups) within {aux_rel:.3e} relative (tol 1e-4), "
                if aux_rel is not None else "")
    print(f"  losses within {rel:.3e} relative (tol 1e-4), {aux_line}parameters within "
          f"{err:.3e} (tol 1e-4); batch schedule {sched['cuda']}, buckets {buckets['cuda']} on "
          f"both; card launches {card_counts}")


# ---------------------------------------------------------------------------
# phase 8: the gram tier at full width
# ---------------------------------------------------------------------------

GRAM_STEPS, GRAM_DELTA = 8, 2.0


def gram_engine(cfg, optimizer, seq: int, micro_batch: int, device,
                moe_groups: int = 1) -> StepEngine:
    """The hand-built gram-tier engine: probes from
    ``repro_torch.models.probes`` on every dense layer (a MoE model's FFNs
    unprobed, routed in ``moe_groups`` groups)."""

    def build(num_micro: int, tier: str):
        return make_train_step(
            cfg, optimizer, num_micro, estimator=tier, moe_groups=moe_groups,
            probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b, moe_groups),
            probe_specs=lambda p, bsz: probes.probe_specs(cfg, bsz, seq, device=device))

    engine = StepEngine(build, lm_bucket_of(micro_batch))
    engine.tier = "gram"
    return engine


def timed_s(fn):
    """(result, seconds) of ``fn()`` on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_gib(fn) -> float:
    """The device memory ``fn()`` allocates at its peak above what was
    allocated before it, GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def stacked_groups(acts, pgrads, scale):
    """The fused groups as ``persample_sq_norm_tree`` ran them before the
    layer table: each group stacked, then one ``psgn_fused``."""
    for key, names in ops.group_layers(acts, pgrads).items():
        if key[0] != "solo" and len(names) >= 2:
            psgn.psgn_fused(torch.stack([acts[n] for n in names]),
                            torch.stack([pgrads[n] * scale for n in names]))


def gram_train_phase() -> tuple[dict, dict]:
    """Returns the launch counts of the training run and of the standalone
    ``persample_sq_norms_gram`` call."""
    phase(f"8. Yi-6B widths, {TRAIN_LAYERS} of 32 layers, bf16, remat: gram-tier DiveBatch "
          f"through a hand-built tiered StepEngine")
    cfg = YI.replace(num_layers=TRAIN_LAYERS, attn_impl="pallas")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    print(f"  coverage of the probes: {probes.coverage(cfg):.4f} of the parameters")
    engine = gram_engine(cfg, sgd(momentum=0.9), TRAIN_SEQ, TRAIN_MICRO, "cuda")
    program = train_lm.make_program("divebatch", m0=4, m_max=8, delta=GRAM_DELTA,
                                    granule=TRAIN_MICRO, lr=TRAIN_LR, tick_every=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=GRAM_STEPS, seq_len=TRAIN_SEQ,
                         micro_batch=TRAIN_MICRO, engine=engine, estimator="gram",
                         log=lambda line: print("  " + line))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = out["records"]
    for rec in recs:
        print(f"  step {rec['step']:2d}: batch {rec['batch']:2d} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms")
    for rec in recs:
        if "diversity" in rec:
            print(f"  tick at step {rec['step']}: Delta {rec['diversity']:.6f}, gns "
                  f"{rec['gns']:.6g}, batch {rec['batch']} -> {rec['next_batch']}")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    if len({rec["batch"] for rec in recs}) < 2:
        raise AssertionError(f"no resize: {[rec['batch'] for rec in recs]}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro,
            "psgn_direct": 0, "psgn_gram": 3 * layers * n_micro, "psgn_fused": 2 * n_micro,
            "psgn_split": 0, "quantize_int8": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    print(f"  launches: {counts} (= {2 * layers}, {layers}, {layers}, 0 direct, "
          f"{3 * layers} gram, 2 fused x {n_micro} microbatches)")
    # bf16 activations and probe gradients at widths that are multiples of
    # 8: every psgn launch of the tier takes the tensor cores
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="gram-tier training")
    routes = kernels.route_counts()
    want_routes = {"chunk_attention": {"tc": want["chunk_attention"], "fma": 0},
                   "flash_dq": {"tc": want["flash_dq"], "fma": 0},
                   "flash_dkv": {"tc": want["flash_dkv"], "fma": 0},
                   "psgn_direct": {"tc": 0, "split": 0, "fma": 0},
                   "psgn_gram": {"tc": want["psgn_gram"], "split": 0, "fma": 0},
                   "psgn_fused": {"tc": want["psgn_fused"], "split": 0, "fma": 0}}
    if routes != want_routes:
        raise AssertionError(f"psgn routes {routes}, expected {want_routes}")
    print(f"  routes: {routes}")
    steady = recs[1:]
    secs = [rec["seconds"] for rec in steady]
    TIER_MS["gram"] = step_ms_by_batch(recs)
    print(f"  per-step ms: median {1e3 * statistics.median(secs):.1f} over steps 2-"
          f"{GRAM_STEPS}; by batch: " + ", ".join(
              f"{m}: {1e3 * statistics.median([x['seconds'] for x in steady if x['batch'] == m]):.1f}"
              for m in sorted({x['batch'] for x in steady})))
    print(f"  tokens/s: {sum(rec['batch'] * TRAIN_SEQ for rec in steady) / sum(secs):.1f} "
          f"over steps 2-{GRAM_STEPS}")
    print(f"  peak device memory: {peak:.2f} GiB")
    print(f"  stats: {json.dumps(engine.stats.as_dict())}")

    # one microbatch, its parts timed apart: the main pass (loss and
    # gradient), the probe pass, the psgn kernels over the probed layers
    mb = {k: torch.from_numpy(v).to("cuda")
          for k, v in TokenStream(cfg.vocab_size, seed=1).batch(
              0, TRAIN_MICRO, TRAIN_SEQ).items()}
    state_params = list(params.parameters())
    hook = lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b)  # noqa: E731
    specs = probes.probe_specs(cfg, TRAIN_MICRO, TRAIN_SEQ, device="cuda")
    split = {}
    for _ in range(2):  # the second round is the one kept
        _, split["main pass"] = timed_s(lambda: torch.autograd.grad(
            tf.loss_fn(cfg, params, mb)[0], state_params))
        (_, acts, pgrads), split["probe pass"] = timed_s(
            lambda: probes.probe_grads(hook, params, specs, mb))
        tree, split["psgn kernels"] = timed_s(
            lambda: ops.persample_sq_norm_tree(acts, pgrads, scale=float(TRAIN_MICRO)))
    print("  one gram-tier microbatch: " + ", ".join(
        f"{k} {1e3 * v:.1f} ms" for k, v in split.items())
        + f"; total {1e3 * sum(split.values()):.1f} ms")
    # where the step's memory peak is: each part's own peak above what is
    # allocated before it (weights, optimizer state and, for the psgn
    # kernels, the probe pass's activations and gradients)
    peaks = {
        "main pass": peak_gib(lambda: torch.autograd.grad(
            tf.loss_fn(cfg, params, mb)[0], state_params)),
        "probe pass": peak_gib(lambda: probes.probe_grads(hook, params, specs, mb)),
        "psgn kernels": peak_gib(
            lambda: ops.persample_sq_norm_tree(acts, pgrads, scale=float(TRAIN_MICRO))),
        "psgn kernels, groups stacked": peak_gib(
            lambda: stacked_groups(acts, pgrads, float(TRAIN_MICRO)))}
    print(f"  resident before the parts {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
          "peak above it: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()))

    # the standalone entry point: every layer alone, so q, k, v, o go direct
    kernels.reset_launch_counts()
    alone, alone_s = timed_s(lambda: probes.persample_sq_norms_gram(cfg, params, mb))
    counts_alone = kernels.launch_counts()
    want_alone = {**{k: 0 for k in counts_alone}, "psgn_direct": 4 * layers,
                  "psgn_gram": 3 * layers, "psgn_split": 7 * layers}
    if counts_alone != want_alone:
        raise AssertionError(f"persample_sq_norms_gram launches {counts_alone}, "
                             f"expected {want_alone}")
    # its float32 deltas take the split route for direct and gram (each
    # delta split once; the activations are bf16), no FMA kernel: the check
    # below holds them against the tree's tensor-core launches on the same
    # activations and gradients
    routes_alone = kernels.route_counts()
    want_routes = {"chunk_attention": {"tc": 0, "fma": 0},
                   "flash_dq": {"tc": 0, "fma": 0},
                   "flash_dkv": {"tc": 0, "fma": 0},
                   "psgn_direct": {"tc": 0, "split": 4 * layers, "fma": 0},
                   "psgn_gram": {"tc": 0, "split": 3 * layers, "fma": 0},
                   "psgn_fused": {"tc": 0, "split": 0, "fma": 0}}
    if routes_alone != want_routes:
        raise AssertionError(f"persample_sq_norms_gram routes {routes_alone}, "
                             f"expected {want_routes}")
    rel = ((alone - tree).abs() / tree.abs()).max().item()
    if rel > PSGN_TOL or not torch.isfinite(alone).all():
        raise AssertionError(f"split route against tensor cores: {alone.tolist()} vs "
                             f"{tree.tolist()}")
    print(f"  persample_sq_norms_gram (split route: {4 * layers} direct, {3 * layers} gram, "
          f"{7 * layers} splits; no FMA launch): {alone.tolist()}; the tree (tensor cores: "
          f"fused, gram) {tree.tolist()}: max rel diff {rel:.3e} (tol {PSGN_TOL})")
    alone_peak = peak_gib(lambda: probes.persample_sq_norms_gram(cfg, params, mb))
    print(f"  persample_sq_norms_gram: {1e3 * alone_s:.1f} ms (host clock, its probe pass "
          f"included); peak device memory above the resident {alone_peak:.2f} GiB")
    del out, params, acts, pgrads, engine
    torch.cuda.empty_cache()
    return counts, counts_alone


# ---------------------------------------------------------------------------
# phase 9: the gram tier, card against CPU
# ---------------------------------------------------------------------------


def gram_card_vs_cpu_phase() -> None:
    phase("9. reduced Yi-6B, float32: gram-tier training on the card (kernels) against "
          "the CPU (plain versions)")
    # hd 64 and d_ff 1024 at S 128: every layer takes the dispatch Yi-6B
    # takes at S 2048 (q/o and k/v fused, gate/up/down gram)
    cfg = get_config("yi-6b", reduced=True).replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024, remat=True,
        attn_impl="pallas")
    seq = 128
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                        granule=2, lr=0.05, tick_every=2)
        engine = gram_engine(cfg, sgd(momentum=0.9), seq, 2, dev)
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, model, program, steps=5, seq_len=seq, micro_batch=2,
                             engine=engine, estimator="gram", log=lambda line: None)
        runs[dev] = (out, kernels.launch_counts())
        if dev == "cuda":
            attn_routes(runs[dev][1], plan_of(cfg, torch.float32),
                        what="float32 gram-tier training")
            fused_routes = kernels.route_counts()["psgn_fused"]
            gram_routes = kernels.route_counts()["psgn_gram"]
    (card_out, card_counts), (cpu_out, cpu_counts) = runs["cuda"], runs["cpu"]

    def rel_err(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.abs(b)))

    losses = {d: [x["loss"] for x in o["records"]] for d, (o, _) in runs.items()}
    deltas = {d: [x["diversity"] for x in o["records"] if "diversity" in x]
              for d, (o, _) in runs.items()}
    sq = {d: o["state"].div_state.sq_norm_sum.item() for d, (o, _) in runs.items()}
    rels = {"losses": rel_err(losses["cuda"], losses["cpu"]),
            "Delta at ticks": rel_err(deltas["cuda"], deltas["cpu"]),
            "sq_norm_sum": rel_err([sq["cuda"]], [sq["cpu"]])}
    if max(rels.values()) > 1e-4:
        raise AssertionError(f"card against CPU: {rels} > 1e-4 relative")
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    if err > 1e-4:
        raise AssertionError(f"parameters differ by {err:.3e} > 1e-4")
    sched = {d: [x["batch"] for x in o["records"]] for d, (o, _) in runs.items()}
    if sched["cuda"] != sched["cpu"]:
        raise AssertionError(f"batch schedules {sched} differ")
    n_micro = sum(x["num_micro"] for x in card_out["records"])
    # float32 x and deltas: each fused group and each gram layer (gate, up,
    # down) on the split route, the x and delta of each split once: 2 x 2
    # for the groups, 6 x 2 for the gram layers
    if (card_counts["psgn_fused"], card_counts["psgn_gram"], card_counts["psgn_split"]) != \
            (2 * n_micro, 6 * n_micro, 16 * n_micro) or card_counts["psgn_direct"] \
            or any(cpu_counts.values()) \
            or fused_routes != {"tc": 0, "split": 2 * n_micro, "fma": 0} \
            or gram_routes != {"tc": 0, "split": 6 * n_micro, "fma": 0}:
        raise AssertionError(f"launches: card {card_counts}, fused routes {fused_routes}, "
                             f"gram routes {gram_routes}, CPU {cpu_counts}")
    print("  " + ", ".join(f"{k} within {v:.3e} relative" for k, v in rels.items())
          + f" (tol 1e-4); parameters within {err:.3e} (tol 1e-4); batch schedule "
          f"{sched['cuda']} on both; card launches {card_counts}; psgn_fused routes "
          f"{fused_routes}, psgn_gram routes {gram_routes}")


# ---------------------------------------------------------------------------
# phase 10: the paper's Trainer on a two-pod PodLadder
# ---------------------------------------------------------------------------

# the paper's synthetic non-convex task (repro/launch/train.py): n 20000, d
# 512, the 2-layer MLP with hidden d // 8; DiveBatch on the moment tier from
# m0 64 (rung 2, pod 0 only) with the reference launcher's delta 0.1 and lr
# 0.1.  At the first epoch boundary Delta is near 1, so m = min(128, 0.1 x
# 16000 x Delta) = 128, and the run moves onto rung 3 (2 pods x 4)
POD_N, POD_D, POD_HIDDEN, POD_LR = 20_000, 512, 64, 0.1
POD_M0, POD_M_MAX, POD_DELTA = 64, 128, 0.1


def pod_trainer(device, seed: int = 0, devices=None, **kw) -> Trainer:
    train, val, _ = sigmoid_synthetic(n=POD_N, d=POD_D, seed=seed)
    params = small.mlp_init(torch.Generator().manual_seed(seed), POD_D, POD_HIDDEN,
                            device=device)
    fns = ModelFns(batch_loss=small.mlp_batch_loss, example_loss=small.mlp_loss,
                   metrics=lambda p, b: {"acc": small.mlp_accuracy(p, b)})
    program = AdaptationProgram(
        DiveBatchPolicy(POD_M0, POD_M_MAX, POD_DELTA, dataset_size=len(train), granule=16),
        POD_LR, estimator="moment")
    return Trainer(fns, params, sgd(momentum=0.9), program, train, val,
                   estimator="moment", seed=seed,
                   elastic=PodLadder(pods=2, devices=devices or [device] * 8, granule=16),
                   **kw)


def run_pod_epochs(trainer: Trainer, epochs: int, log=None) -> list[tuple]:
    """``(batch, rung index, record)`` per epoch: the batch size and rung
    the epoch ran at (a resize applies at the start of the next epoch; the
    record's batch_size is the decision for the next)."""
    out = []
    for _ in range(epochs):
        bsz = trainer.adapt.batch_size
        rec = trainer.run_epoch()
        out.append((bsz, trainer.rung.index, rec))
        if log:
            log(*out[-1])
    return out


def print_epoch(bsz, rung, rec) -> None:
    print(f"  epoch {rec.epoch}: batch {bsz}, rung {rung}, {rec.steps} steps, train loss "
          f"{rec.train_loss:.6f}, val loss {rec.val_loss:.6f}, val acc "
          f"{rec.val_metrics['acc']:.4f}, Delta {rec.diversity:.6f} -> batch "
          f"{rec.batch_size}; {1e3 * rec.wall_s / rec.steps:.3f} ms per step (epoch wall / "
          f"steps)")


def pod_phase() -> dict:
    phase("10. the paper's Trainer on a two-pod PodLadder (8 virtual devices on the card): "
          f"MLP {POD_D} -> {POD_HIDDEN} -> 1 on sigmoid_synthetic(n={POD_N})")
    trainer = pod_trainer("cuda")
    n_leaves = len(list(trainer.params.parameters()))
    numel = sum(p.numel() for p in trainer.params.parameters())
    print(f"  {numel} parameters in {n_leaves} leaves; DiveBatch m0 {POD_M0}, m_max "
          f"{POD_M_MAX}, delta {POD_DELTA}, lr {POD_LR}, momentum 0.9, moment tier; "
          f"ladder {trainer.elastic}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs = run_pod_epochs(trainer, 3, print_epoch)
    # phase 12b resumes epoch 3 from a checkpoint and is held against this
    after_3 = {"runs": list(runs),
               "params": [p.detach().cpu().clone() for p in trainer.params.parameters()]}
    if runs[-1][1] != 3:
        raise AssertionError(f"the run did not reach the cross-pod rung: {runs}")
    if runs[0][:2] != (POD_M0, 2):
        raise AssertionError(f"the run did not start at batch {POD_M0} on rung 2: {runs}")
    trainer.elastic.health.mark_lost(1)
    src, dst = trainer.demote(note="pod 1 lost")
    if (src, dst) != (3, 2) or trainer.state.err_state is not None:
        raise AssertionError(f"demote gave {src} -> {dst}, residuals "
                             f"{trainer.state.err_state is not None}")
    print(f"  pod 1 lost: demoted rung {src} -> {dst}, residuals dropped")
    runs += run_pod_epochs(trainer, 1, print_epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # phase 16c runs the same cell with each pod a rank and is held against this
    final = {"epochs": [pod_epoch(bsz, rung, rec) for bsz, rung, rec in runs],
             "params": [p.detach().cpu().clone() for p in trainer.params.parameters()]}
    counts = kernels.launch_counts()
    cross_steps = sum(rec.steps for _, rung, rec in runs
                      if trainer.elastic.rungs[rung].pods > 1)
    want = {k: 0 for k in counts} | {"quantize_int8": 2 * n_leaves * cross_steps}
    if counts != want or cross_steps == 0:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    if not all(np.isfinite(rec.val_loss) for _, _, rec in runs):
        raise AssertionError(f"non-finite val loss: {runs}")
    if runs[-1][2].val_loss > runs[0][2].val_loss:
        raise AssertionError("the val loss rose over the run")
    print(f"  quantize_int8 launches {counts['quantize_int8']} (= 2 pods x {n_leaves} leaves "
          f"x {cross_steps} cross-pod steps); no other kernel")
    wire = numel + 4 * n_leaves
    print(f"  wire bytes per pod per exchange: {wire} (int8 codes + a float32 scale per "
          f"leaf) against {4 * numel} in float32, {4 * numel / wire:.3f}x fewer")
    print(f"  {len(runs)} epochs in {wall:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.2f} MiB")
    print(f"  stats: {json.dumps(trainer.engine.stats.as_dict())}")
    return counts, after_3, final


def pod_epoch(bsz, rung, rec) -> tuple:
    """An epoch of the pod cell as phase 16c compares it: (batch, rung,
    steps, train loss, val loss, Delta)."""
    return (bsz, rung, rec.steps, rec.train_loss, rec.val_loss, rec.diversity)


# ---------------------------------------------------------------------------
# phase 11: the pod slice, card against CPU
# ---------------------------------------------------------------------------

# limits set from an H100 run (NVIDIA H100 80GB HBM3, 700 W): the losses
# agreed to 5.3e-5 relative, the parameters after 375 steps to 6.372e-3, and
# one exchange from the same state and batch flipped 1 of 65794 codes and
# left the other residuals within 9.4e-5 quanta
POD_LOSS_RTOL = 1e-3
POD_PARAM_ATOL = 1e-2
POD_STEP_FLIPS_MAX = 8
POD_STEP_KEPT_QUANTA = 1e-3


def residual_gap(ours: list, theirs: list, scales: torch.Tensor) -> tuple[int, float]:
    """(codes that flipped, largest residual difference of the others in
    quanta) between stacked per-pod residuals; ``scales`` is (pods, leaves),
    a pod's leaf's quantum.  Codes that agree leave residuals within
    rounding of each other; a flipped code moves one by about a quantum
    (|r| <= quantum / 2 on both sides)."""
    flipped, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        d = (a.cpu() - b.cpu()).abs() / scales[:, i].reshape((-1,) + (1,) * (a.dim() - 1))
        flipped += int((d > 0.5).sum())
        kept = d[d <= 0.5]
        worst = max(worst, kept.max().item() if kept.numel() else 0.0)
    return flipped, worst


def pod_card_vs_cpu_phase() -> None:
    phase("11. the pod slice on the card ([cuda:0] * 8) against the CPU ([cpu] * 8), "
          "identical weights, 2 epochs")
    runs, scales = {}, {}
    for dev in ("cuda", "cpu"):
        trainer = pod_trainer(dev)
        step = trainer.engine.step

        def capture(state, batch, lr, step=step, dev=dev):
            new, metrics = step(state, batch, lr)
            if "scales" in metrics:
                scales[dev] = metrics["scales"]
            return new, metrics

        trainer.engine.step = capture
        runs[dev] = (trainer, run_pod_epochs(trainer, 2))
    (tc, rc), (tp, rp) = runs["cuda"], runs["cpu"]
    sched = {d: [(bsz, rung, rec.steps) for bsz, rung, rec in r]
             for d, (_, r) in runs.items()}
    if sched["cuda"] != sched["cpu"] or sched["cuda"][-1][1] != 3:
        raise AssertionError(f"schedules (batch, rung, steps) differ: {sched}")
    rels = {}
    for field in ("train_loss", "val_loss"):
        a = np.array([getattr(rec, field) for _, _, rec in rc])
        b = np.array([getattr(rec, field) for _, _, rec in rp])
        rels[field] = float(np.max(np.abs(a - b) / np.abs(b)))
    if max(rels.values()) > POD_LOSS_RTOL:
        raise AssertionError(f"losses differ: {rels} > {POD_LOSS_RTOL} relative")
    flipped, worst_kept = residual_gap(tc.state.err_state, tp.state.err_state,
                                       scales["cpu"])
    perr = max((a.detach().cpu() - b.detach()).abs().max().item()
               for a, b in zip(tc.params.parameters(), tp.params.parameters()))
    if perr > POD_PARAM_ATOL:
        raise AssertionError(f"parameters differ by {perr:.3e} > {POD_PARAM_ATOL}")
    n_res = sum(e.numel() for e in tp.state.err_state)
    # the runs have drifted apart by then; one exchange from the SAME state
    # and batch on both devices shows what a single step makes of rounding
    batch = {k: torch.from_numpy(v)
             for k, v in tp.train_data.get(np.arange(2 * POD_M0)).items()}
    one = {}
    for dev, t in (("cuda", tc), ("cpu", tp)):
        state = place(copy.deepcopy(tp.state), t.rung.plan)
        new, metrics = t.engine.jitted(2 * POD_M0)(state, batch, POD_LR)
        one[dev] = ([e.cpu() for e in new.err_state], metrics["scales"].cpu())
    step_flips, step_kept = residual_gap(one["cuda"][0], one["cpu"][0], one["cpu"][1])
    if step_flips > POD_STEP_FLIPS_MAX or step_kept > POD_STEP_KEPT_QUANTA:
        raise AssertionError(
            f"one exchange from the same state: {step_flips} of {n_res} codes flipped (tol "
            f"{POD_STEP_FLIPS_MAX}), the others' residuals within {step_kept:.3e} quanta "
            f"(tol {POD_STEP_KEPT_QUANTA})")
    print(f"  schedule (batch, rung, steps) {sched['cuda']} on both; train/val losses "
          f"within {rels['train_loss']:.3e} / {rels['val_loss']:.3e} relative (tol "
          f"{POD_LOSS_RTOL}); parameters within {perr:.3e} (tol {POD_PARAM_ATOL}); "
          f"{flipped} of {n_res} codes flipped at the last exchange, the others within "
          f"{worst_kept:.2e} quanta; one exchange from the same state and batch: "
          f"{step_flips} of {n_res} codes flipped (tol {POD_STEP_FLIPS_MAX}), the others' "
          f"residuals within {step_kept:.3e} quanta (tol {POD_STEP_KEPT_QUANTA})")


# ---------------------------------------------------------------------------
# phase 12: checkpoint and resume on the card
# ---------------------------------------------------------------------------


def ckpt_bytes(path: str) -> tuple[int, int]:
    """(bytes, npz volumes) of a checkpoint directory."""
    n, vols = 0, 0
    for root, _, files in os.walk(path):
        for f in files:
            n += os.path.getsize(os.path.join(root, f))
            vols += f.endswith(".npz")
    return n, vols


def ckpt_root(tag: str) -> str:
    """A temporary checkpoint root inside the checkout's ``build/`` (removed
    by the caller)."""
    (ROOT / "build").mkdir(exist_ok=True)
    return tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_", dir=ROOT / "build")


def lm_resume_phase() -> dict:
    phase(f"12a. checkpoint and resume at full width: Yi-6B widths, {CKPT_LAYERS} of 32 "
          f"layers, bf16, remat, 8 steps through train_lm.train with a checkpoint at each "
          f"tick; steps 5-8 again from the step-4 checkpoint")
    cfg = YI.replace(num_layers=CKPT_LAYERS)

    def program():
        return train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                     granule=TRAIN_MICRO, lr=TRAIN_LR, tick_every=4)

    root = ckpt_root("lm")
    try:
        mgr = CheckpointManager(root, keep=2)
        params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        print(f"  checkpoints under {root}: {shutil.disk_usage(root).free / 1e9:.1f} GB free")
        full = train_lm.train(cfg, params, program(), steps=8, seq_len=TRAIN_SEQ,
                              micro_batch=TRAIN_MICRO, attn_impl="pallas", ckpt=mgr,
                              log=lambda line: None)
        torch.cuda.synchronize()
        for rec in full["records"]:
            if "ckpt_copy_s" in rec:
                n, vols = ckpt_bytes(os.path.join(root, f"step_{rec['step']:010d}"))
                print(f"  checkpoint at step {rec['step']}: {n / 1e9:.3f} GB in {vols} npz "
                      f"volumes; device -> host {rec['ckpt_copy_s']:.2f} s "
                      f"({n / rec['ckpt_copy_s'] / 1e9:.2f} GB/s), writes "
                      f"{rec['ckpt_write_s']:.2f} s ({n / rec['ckpt_write_s'] / 1e9:.2f} GB/s)")
        want = [(r["step"], r["batch"], r["loss"]) for r in full["records"][4:]]
        del full, params
        torch.cuda.empty_cache()
        # a fresh state (other weights) restored from the step-4 checkpoint
        params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
        state = init_state(params, sgd(momentum=0.9))
        prog = program()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (state, step), restore_s = timed_s(
            lambda: train_lm.resume(mgr, state, prog, step=4))
        print(f"  restore of step {step}: {restore_s:.2f} s; program at batch "
              f"{prog.batch_size}")
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, params, prog, steps=8, seq_len=TRAIN_SEQ,
                             micro_batch=TRAIN_MICRO, attn_impl="pallas", state=state,
                             start_step=step, log=lambda line: None)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        got = [(r["step"], r["batch"], r["loss"]) for r in out["records"]]
        for (s_, b, loss), (_, _, ref) in zip(got, want):
            print(f"  step {s_}: batch {b}, loss {loss!r} resumed, {ref!r} uninterrupted")
        if got != want:
            raise AssertionError(f"resumed steps {got} differ from the uninterrupted {want}")
        n_micro = sum(r["num_micro"] for r in out["records"])
        layers = cfg.num_layers
        want_counts = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
                       "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro,
                       **NO_PSGN}
        if counts != want_counts:
            raise AssertionError(f"kernel launches {counts}, expected {want_counts}")
        attn_routes(counts, plan_of(cfg, torch.bfloat16), what="resumed training")
        print(f"  resumed steps 5-8: batch schedule and losses bit-identical to the "
              f"uninterrupted run; launches {counts} (= {2 * layers}, {layers}, {layers} "
              f"x {n_micro} microbatches); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del out, state, params
        torch.cuda.empty_cache()
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pod_resume_phase(after_3: dict) -> dict:
    phase("12b. checkpoint and resume on the two-pod PodLadder: 2 epochs with a checkpoint "
          "each, then a fresh Trainer on a fresh ladder resumes and runs epoch 3")
    root = ckpt_root("pod")
    try:
        first = pod_trainer("cuda", ckpt=CheckpointManager(root), ckpt_every=1)
        runs = run_pod_epochs(first, 2)
        same = [(b, r, rec.train_loss, rec.val_loss) for b, r, rec in runs] == \
            [(b, r, rec.train_loss, rec.val_loss) for b, r, rec in after_3["runs"][:2]]
        print(f"  epochs 1-2 with checkpoints: schedule {[(b, r, x.steps) for b, r, x in runs]}"
              f"; bit-identical to phase 10's first two: {same}")
        second = pod_trainer("cuda", ckpt=CheckpointManager(root))
        start = second.rung.index
        if not second.resume() or second.rung.index != 3:
            raise AssertionError(f"resume landed on rung {second.rung.index}, not 3")
        print(f"  fresh Trainer on rung {start} resumed epoch {second.cursor.epoch} onto rung "
              f"{second.rung.index} at batch {second.adapt.batch_size}")
        kernels.reset_launch_counts()
        resumed = run_pod_epochs(second, 1, print_epoch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        b, r, rec = resumed[0]
        rb, rr, ref = after_3["runs"][2]
        if (b, r, rec.steps) != (rb, rr, ref.steps):
            raise AssertionError(f"epoch 3 ran {(b, r, rec.steps)}, phase 10 {(rb, rr, ref.steps)}")
        rels = {f: abs(getattr(rec, f) - getattr(ref, f)) / abs(getattr(ref, f))
                for f in ("train_loss", "val_loss")}
        perr = max((a.detach().cpu() - p).abs().max().item()
                   for a, p in zip(second.params.parameters(), after_3["params"]))
        if max(rels.values()) > POD_LOSS_RTOL or perr > POD_PARAM_ATOL:
            raise AssertionError(f"epoch 3 losses {rels} (tol {POD_LOSS_RTOL}), parameters "
                                 f"{perr:.3e} (tol {POD_PARAM_ATOL})")
        want = {k: 0 for k in counts} | {"quantize_int8": 2 * 4 * rec.steps}
        if counts != want:
            raise AssertionError(f"kernel launches {counts}, expected {want}")
        print(f"  epoch 3 against phase 10's: schedule (batch, rung, steps) {(b, r, rec.steps)} "
              f"on both; train/val losses within {rels['train_loss']:.3e} / "
              f"{rels['val_loss']:.3e} relative (tol {POD_LOSS_RTOL}), parameters within "
              f"{perr:.3e} (tol {POD_PARAM_ATOL}): not to the bit, because the compression "
              f"residuals are transient wire state, never checkpointed (as in the reference), "
              f"so the resumed run starts them at zero; quantize_int8 launches "
              f"{counts['quantize_int8']} (= 2 pods x 4 leaves x {rec.steps} cross-pod steps)")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the paper's CIFAR model and launch/train.py's defaults (m0 128, m_max 2048,
# delta 0.1, granule 16, lr 0.1, momentum 0.9) on CIFAR-10's 50 000 images
# (imagelike_classification at hw 32 splits them 45 000 / 5 000)
CIFAR_N, CIFAR_EPOCHS = 50_000, 3


def step_ms(engine, state, batch, n: int = 5) -> float:
    """Median ms of ``n`` steps of ``engine`` on a copy of ``state``."""
    state = copy.deepcopy(state)
    engine.step(state, batch, 0.1)
    times = []
    for _ in range(n):
        _, dt = timed_s(lambda: engine.step(state, batch, 0.1))
        times.append(1e3 * dt)
    return statistics.median(times)


def resnet_resume_phase() -> None:
    phase(f"12c. the paper's ResNet-20 (GroupNorm, width 16, 10 classes) on CIFAR-shaped "
          f"imagelike_classification(n={CIFAR_N}, hw=32): DiveBatch on the exact tier, "
          f"{CIFAR_EPOCHS} epochs with a checkpoint each, then epoch 3 again from the "
          f"epoch-2 checkpoint")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    print(f"  cuDNN TF32 {torch.backends.cudnn.allow_tf32}, matmul TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN deterministic algorithms on")
    train, val = imagelike_classification(n=CIFAR_N, hw=32, num_classes=10, seed=0)
    args = train_cli.parser().parse_args(["--task", "imagelike"])
    fns = ModelFns(batch_loss=resnet.resnet_batch_loss, example_loss=resnet.resnet_loss,
                   metrics=lambda p, b: {"acc": resnet.resnet_accuracy(p, b)})
    root = ckpt_root("resnet")

    def trainer(mgr) -> Trainer:
        params = resnet.resnet_init(torch.Generator().manual_seed(0), depth=20, width=16,
                                    device="cuda")
        return Trainer(fns, params, sgd(momentum=args.momentum),
                       train_cli.make_program(args, len(train)), train, val,
                       estimator="exact", seed=0, ckpt=mgr, ckpt_every=1)

    try:
        t = trainer(CheckpointManager(root, keep=CIFAR_EPOCHS))
        n_params = sum(p.numel() for p in t.params.parameters())
        print(f"  {n_params} parameters; {len(train)} train / {len(val)} val images; "
              f"m0 {args.batch_size}, m_max {args.max_batch_size}, delta {args.delta}, lr "
              f"{args.lr}, momentum {args.momentum}")
        moment = StepEngine.for_model_fns(fns, sgd(momentum=0.9), estimator="moment")
        kernels.reset_launch_counts()
        for _ in range(CIFAR_EPOCHS):
            bsz = t.adapt.batch_size
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            rec = t.run_epoch()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            batch = place(train.get(np.arange(bsz)), None)
            exact_ms = step_ms(t.engine, t.state, batch)
            moment_ms = step_ms(moment, t.state, batch)
            print(f"  epoch {rec.epoch}: batch {bsz}, {rec.steps} steps, "
                  f"{1e3 * rec.wall_s / rec.steps:.2f} ms per step (epoch wall / steps), "
                  f"{rec.steps * bsz / rec.wall_s:.0f} images/s, val acc "
                  f"{rec.val_metrics['acc']:.4f}, val loss {rec.val_loss:.6f}, Delta "
                  f"{rec.diversity:.6f} -> batch {rec.batch_size}; peak "
                  f"{peak:.2f} GiB; one step at batch {bsz}: exact tier {exact_ms:.2f} ms, "
                  f"moment tier {moment_ms:.2f} ms: per-sample gradients by vmap "
                  f"{100 * (1 - moment_ms / exact_ms):.1f}% of the step")
        counts = kernels.launch_counts()
        if any(counts.values()):
            raise AssertionError(f"the ResNet path launched kernels: {counts}")
        n, vols = ckpt_bytes(os.path.join(root, "step_0000000002"))
        print(f"  checkpoints {t.ckpt.all_steps()}, {n / 1e6:.2f} MB and {vols} volumes each; "
              f"no hand-written kernel on this path (convolutions on cuDNN): {counts}")
        want = t.history[-1]
        shutil.rmtree(os.path.join(root, f"step_{CIFAR_EPOCHS:010d}"))
        again = trainer(CheckpointManager(root))
        (_, restore_s) = timed_s(again.resume)
        rec = again.run_epoch()
        diff = max((a - b).abs().max().item()
                   for a, b in zip(again.params.parameters(), t.params.parameters()))
        print(f"  resumed from the epoch-{CIFAR_EPOCHS - 1} checkpoint in {restore_s:.3f} s "
              f"(the epoch-{CIFAR_EPOCHS} one removed): epoch {rec.epoch} batch "
              f"{rec.batch_size}, {rec.steps} steps, val loss {rec.val_loss!r} against "
              f"{want.val_loss!r}, train loss {rec.train_loss!r} against "
              f"{want.train_loss!r}; parameters differ by {diff}")
        if (rec.batch_size, rec.steps, rec.train_loss, rec.val_loss, rec.diversity) != \
                (want.batch_size, want.steps, want.train_loss, want.val_loss, want.diversity) \
                or diff != 0.0:
            raise AssertionError("the resumed epoch is not the uninterrupted one")
        print("  the resumed epoch is the uninterrupted one to the bit")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: the new paths, card against CPU
# ---------------------------------------------------------------------------

# launch/train.py's imagelike task at its own size (ResNet depth 8, width 8,
# hw 16, n 6000).  Its training amplifies rounding fast: at lr 0.1, batch
# 128, a one-ulp change of every weight moves the parameters past 1e-3
# within 30 steps (tests/test_torch_resnet.py), so the run is kept to a few
# large-batch steps at lr 0.02 (m0 1024, delta 10)
CLI_FLAGS = ["--task", "imagelike", "--batch-size", "1024", "--delta", "10", "--lr", "0.02",
             "--ckpt-every", "1"]


@contextlib.contextmanager
def float32_as_float64():
    """Inside: every float32 the port asks for is float64 (``dtype=`` of the
    tensor factories and ``vector_norm``, ``Tensor.to``, ``Tensor.float``),
    and ``launch/train.py``'s tasks build float64 parameters and data, so a
    CPU run computes in float64 where the port pins float32 (norm
    statistics, accumulators, the loss, the optimizer's update).  The lr
    stays the float32 value both runs take."""
    f32, f64 = torch.float32, torch.float64
    saved = []

    def patch(owner, name, new):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def widening(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if kw.get("dtype") is f32:
                kw["dtype"] = f64
            return fn(*args, **kw)
        return call

    for name in ("zeros", "zeros_like", "ones", "empty", "full", "tensor", "as_tensor"):
        patch(torch, name, widening(getattr(torch, name)))
    patch(torch.linalg, "vector_norm", widening(torch.linalg.vector_norm))
    to = torch.Tensor.to
    patch(torch.Tensor, "to", lambda self, *args, **kw: to(
        self, *(f64 if a is f32 else a for a in args),
        **{k: f64 if v is f32 else v for k, v in kw.items()}))
    patch(torch.Tensor, "float", lambda self, *args, **kw: to(self, f64))
    build = train_cli.build_task

    def build64(task, seed, device):
        fns, params, train, val = build(task, seed, device)
        def wide(d):
            return ArrayDataset({k: v.astype(np.float64) if v.dtype == np.float32 else v
                                 for k, v in d.arrays.items()})
        return fns, params.double(), wide(train), wide(val)

    patch(train_cli, "build_task", build64)
    try:
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def cli_card_vs_cpu_phase() -> None:
    phase("13. launch/train.py's imagelike task on the card against the CPU (cuDNN and "
          "matmul TF32 off, cuDNN's deterministic algorithms), identical weights, 2 "
          "epochs; checkpoints resumed across devices")
    # the gap sits in Delta (per-sample norms by vmap); cuDNN's algorithm
    # choice moved it between 2.4e-5 and 6.2e-5 over runs of the default
    # algorithms, the deterministic ones repeat their result
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    roots = {dev: ckpt_root(f"cli_{dev}") for dev in ("cuda", "cpu")}
    try:
        runs = {dev: train_cli.main(["--device", dev, "--epochs", "2",
                                     "--ckpt-dir", roots[dev]] + CLI_FLAGS)
                for dev in ("cuda", "cpu")}
        hist = {d: r["history"] for d, r in runs.items()}
        sched = {d: [(h.batch_size, h.steps) for h in hs] for d, hs in hist.items()}
        if sched["cuda"] != sched["cpu"]:
            raise AssertionError(f"schedules (next batch, steps) differ: {sched}")
        gaps = {f: max(abs(getattr(a, f) - getattr(b, f)) / abs(getattr(b, f))
                       for a, b in zip(hist["cuda"], hist["cpu"]))
                for f in ("train_loss", "val_loss", "diversity")}
        rel = max(gaps.values())
        perr = max((a.detach().cpu() - b.detach()).abs().max().item()
                   for a, b in zip(runs["cuda"]["trainer"].params.parameters(),
                                   runs["cpu"]["trainer"].params.parameters()))
        if rel > 1e-4 or perr > 1e-4:
            raise AssertionError(f"losses and Delta within {rel:.3e} relative (tol 1e-4), "
                                 f"parameters within {perr:.3e} (tol 1e-4)")
        print(f"  schedule (next batch, steps) {sched['cuda']} on both; losses and Delta "
              f"within {rel:.3e} relative (tol 1e-4; "
              + ", ".join(f"{f} {g:.3e}" for f, g in gaps.items())
              + f"), parameters within {perr:.3e} (tol 1e-4)")
        # which side carries the gap: each against the same run in float64,
        # with the card again on PyTorch's own convolutions (im2col and
        # cuBLAS products, TF32 off) in place of cuDNN's algorithms, and the
        # CPU again at 1 and 4 threads (other summation orders, float32 all)
        threads = torch.get_num_threads()
        for n in (1, 4):
            torch.set_num_threads(n)
            runs[f"cpu, {n} threads"] = train_cli.main(["--device", "cpu", "--epochs", "2"]
                                                       + CLI_FLAGS[:-2])
        torch.set_num_threads(threads)
        with float32_as_float64():
            wide = train_cli.main(["--device", "cpu", "--epochs", "2"] + CLI_FLAGS[:-2])
        wide_params = list(wide["trainer"].params.parameters())
        if {p.dtype for p in wide_params} != {torch.float64}:
            raise AssertionError("the float64 run kept a float32 parameter")
        torch.backends.cudnn.enabled = False
        try:
            t0 = time.perf_counter()
            runs["cuda, no cuDNN"] = train_cli.main(["--device", "cuda", "--epochs", "2"]
                                                    + CLI_FLAGS[:-2])
            native_s = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.enabled = True
        off = {}
        for run, label in (("cuda", "card (cuDNN)"), ("cuda, no cuDNN", "card (no cuDNN)"),
                           ("cpu", f"CPU ({threads} threads)"),
                           ("cpu, 1 threads", "CPU (1 thread)"),
                           ("cpu, 4 threads", "CPU (4 threads)")):
            gaps64 = {f: max(abs(getattr(a, f) - getattr(b, f)) / abs(getattr(b, f))
                             for a, b in zip(runs[run]["history"], wide["history"]))
                      for f in ("train_loss", "val_loss", "diversity")}
            p_off = max((a.detach().cpu().double() - b.detach()).abs().max().item()
                        for a, b in zip(runs[run]["trainer"].params.parameters(),
                                        wide_params))
            off[label] = gaps64["diversity"]
            print(f"  {label}, float32, against the CPU in float64: "
                  + ", ".join(f"{f} {g:.3e}" for f, g in gaps64.items())
                  + f" relative; parameters within {p_off:.3e}")
        cpu_off = [v for k, v in off.items() if k.startswith("CPU")]
        print(f"  Delta's distance to float64 (relative): card {off['card (cuDNN)']:.3e} "
              f"with cuDNN, {off['card (no cuDNN)']:.3e} without ({native_s:.1f} s); CPU "
              f"{min(cpu_off):.3e} to {max(cpu_off):.3e} over thread counts")
        cont = {}
        for dev, src in (("cpu", "cuda"), ("cuda", "cpu")):
            out = train_cli.main(["--device", dev, "--epochs", "3", "--resume",
                                  "--ckpt-dir", roots[src]] + CLI_FLAGS)
            cont[dev] = out["history"][-1]
            print(f"  the {src} checkpoint resumed on {dev}: epoch {cont[dev].epoch} at batch "
                  f"{hist[src][-1].batch_size}, {cont[dev].steps} steps, val loss "
                  f"{cont[dev].val_loss:.6f}, next batch {cont[dev].batch_size}")
        a, b = cont["cpu"], cont["cuda"]
        if (a.epoch, a.batch_size, a.steps) != (b.epoch, b.batch_size, b.steps):
            raise AssertionError(f"the continued epochs differ: {a} / {b}")
        print(f"  both continue epoch {a.epoch} to the same schedule; val losses within "
              f"{abs(a.val_loss - b.val_loss) / abs(b.val_loss):.3e} relative")
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled) = saved
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 14: hubert-xlarge, the encoder, at full width
# ---------------------------------------------------------------------------

HUBERT_STEPS, HUBERT_GRAM_LAYERS = 12, 12


# the largest logit gap allowed between the kernel lane and the plain dense
# lane (``attn_impl="dense"``) of one bf16 encoder, relative to the largest
# logit: both round the attention output to bf16 at 48 layers, at different
# points (the kernel rounds p before P V, the dense lane its softmax), which
# a random walk over the layers puts near sqrt(48) x 2^-8 = 2.7e-2; 5e-2 is
# about 13 bf16 ulps at the logits' scale
DENSE_GAP_TOL = 5e-2


def encode_phase(cfg, params) -> dict:
    """(a) ``prefill_step`` on 4 sequences: finite (4, S, V) logits, one
    chunk-forward launch per layer (on its planned route) and nothing else;
    then the same frames through the plain dense attention lane, the logits
    within ``DENSE_GAP_TOL`` of the largest one."""
    n_layers = cfg.num_layers
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in train_lm.frame_batches(cfg, 0)(0, 4, HUBERT_SEQ).items()}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    (logits, cache), _ = timed_s(lambda: tf.prefill_step(cfg, params, batch))
    counts = kernels.launch_counts()
    if logits.shape != (4, HUBERT_SEQ, cfg.vocab_size) or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all() or cache != {}:
        raise AssertionError(f"encoder logits {tuple(logits.shape)} {logits.dtype}, "
                             f"finite {bool(torch.isfinite(logits).all())}, cache {cache}")
    want = {**{k: 0 for k in counts}, "chunk_attention": n_layers}
    if counts != want:
        raise AssertionError(f"encode launches {counts}, expected {want}")
    plan = plan_of(cfg, torch.bfloat16)
    attn_routes(counts, plan, what="encoding")
    _, secs = timed_s(lambda: tf.prefill_step(cfg, params, batch))
    peak = peak_gib(lambda: tf.prefill_step(cfg, params, batch))
    print(f"  (a) encode 4 x {HUBERT_SEQ} frames through prefill_step: logits "
          f"{tuple(logits.shape)} float32, finite; launches {counts} (= {n_layers} chunk "
          f"forwards, {plan['chunk_attention']}); {1e3 * secs:.1f} ms (host clock, second "
          f"call), {4 * HUBERT_SEQ / secs:.1f} frames/s; peak device memory above the "
          f"resident {peak:.2f} GiB")
    kernels.reset_launch_counts()
    dense = tf.prefill_step(cfg.replace(attn_impl="dense"), params, batch)[0]
    torch.cuda.synchronize()
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the dense lane launched {kernels.launch_counts()}")
    gap = (logits - dense).abs().max().item()
    scale = dense.abs().max().item()
    if not gap <= DENSE_GAP_TOL * scale:
        raise AssertionError(f"kernel lane against the dense lane: largest logit gap "
                             f"{gap:.4e} > {DENSE_GAP_TOL} x {scale:.4e}")
    print(f"  the same frames through the dense lane (attn_impl='dense', no kernel): "
          f"largest logit gap {gap:.4e}, {gap / scale:.3e} of the largest logit "
          f"{scale:.4e} (tol {DENSE_GAP_TOL}); logit rms {rms(dense):.4e}")
    del logits, batch, dense
    return counts


def encoder_train_phase(cfg, params, n_matmul: int) -> dict:
    """(b) 12 moment-tier steps through ``StepEngine.for_lm`` under DiveBatch."""
    program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                    granule=HUBERT_MICRO, lr=TRAIN_LR, tick_every=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=HUBERT_STEPS, seq_len=HUBERT_SEQ,
                         micro_batch=HUBERT_MICRO, attn_impl="pallas",
                         batches=train_lm.frame_batches(cfg, 1),
                         log=lambda line: print("    " + line))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = out["records"]
    for rec in recs:
        print(f"    step {rec['step']:2d}: batch {rec['batch']:2d} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="encoder training")
    print(f"  (b) launches: {counts} (= {2 * layers}, {layers}, {layers} x {n_micro} "
          f"microbatches); attention routes {attention_routes()} (the plan's: "
          f"{plan_of(cfg, torch.bfloat16)})")
    hd, h, s = cfg.resolved_head_dim, cfg.num_heads, HUBERT_SEQ

    def model_flops(batch: int) -> float:
        # 6 N per frame for the products, plus non-causal attention: 2
        # products forward and 4 backward of 2 * hd per (row, key) pair
        return 6 * n_matmul * batch * s + 12 * hd * h * layers * batch * s * s

    steady = recs[1:]
    secs = [rec["seconds"] for rec in steady]
    flops = [model_flops(rec["batch"]) for rec in steady]
    print(f"  per-step ms: median {1e3 * statistics.median(secs):.1f} over steps 2-"
          f"{HUBERT_STEPS}; by batch: " + ", ".join(
              f"{m}: {1e3 * statistics.median([x['seconds'] for x in steady if x['batch'] == m]):.1f}"
              for m in sorted({x['batch'] for x in steady})))
    print(f"  frames/s: {sum(rec['batch'] * s for rec in steady) / sum(secs):.1f} over steps "
          f"2-{HUBERT_STEPS}")
    print("  model FLOPs per step: " + ", ".join(
        f"batch {m}: {model_flops(m):.4e}" for m in sorted({x['batch'] for x in steady}))
          + f"; achieved {sum(flops) / sum(secs) / 1e12:.2f} TFLOP/s = "
          f"{100 * sum(flops) / sum(secs) / PEAK_BF16:.2f}% of 989 TFLOP/s")
    print(f"  peak device memory: {peak:.2f} GiB")
    print(f"  stats: {json.dumps(out['engine'].stats.as_dict())}")
    del out
    return counts


def encoder_gram_phase(cfg) -> dict:
    """(c) the gram tier at a depth cut, 8 steps with a resize; exact launch
    counts from ``ops.group_layers``' grouping; one microbatch in parts."""
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    engine = gram_engine(cfg, sgd(momentum=0.9), HUBERT_SEQ, HUBERT_MICRO, "cuda")
    program = train_lm.make_program("divebatch", m0=4, m_max=8, delta=GRAM_DELTA,
                                    granule=HUBERT_MICRO, lr=TRAIN_LR, tick_every=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=GRAM_STEPS, seq_len=HUBERT_SEQ,
                         micro_batch=HUBERT_MICRO, engine=engine, estimator="gram",
                         batches=train_lm.frame_batches(cfg, 2),
                         log=lambda line: print("    " + line))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    routes = kernels.route_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = out["records"]
    for rec in recs:
        print(f"    step {rec['step']:2d}: batch {rec['batch']:2d} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    if len({rec["batch"] for rec in recs}) < 2:
        raise AssertionError(f"no resize: {[rec['batch'] for rec in recs]}")
    # one microbatch in parts: the main pass, the probe pass, the psgn kernels
    mb = {k: torch.from_numpy(v).to("cuda")
          for k, v in train_lm.frame_batches(cfg, 3)(0, HUBERT_MICRO, HUBERT_SEQ).items()}
    hook = lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b)  # noqa: E731
    specs = probes.probe_specs(cfg, HUBERT_MICRO, HUBERT_SEQ, device="cuda")
    state_params = list(params.parameters())
    split = {}
    for _ in range(2):  # the second round is the one kept
        _, split["main pass"] = timed_s(lambda: torch.autograd.grad(
            tf.loss_fn(cfg, params, mb)[0], state_params))
        (_, acts, pgrads), split["probe pass"] = timed_s(
            lambda: probes.probe_grads(hook, params, specs, mb))
        _, split["psgn kernels"] = timed_s(
            lambda: ops.persample_sq_norm_tree(acts, pgrads, scale=float(HUBERT_MICRO)))
    # the launches one microbatch makes, from the tree's grouping: a group of
    # two or more same-shape direct layers is one fused launch, every other
    # layer one direct or gram launch
    per_mb = {"psgn_direct": 0, "psgn_gram": 0, "psgn_fused": 0}
    groups = ops.group_layers(acts, pgrads)
    for key, names in groups.items():
        if key[0] != "solo" and len(names) >= 2:
            per_mb["psgn_fused"] += 1
        else:
            for n in names:
                x, d = acts[n], pgrads[n]
                per_mb["psgn_" + ops.choose_method(x.shape[1], x.shape[2], d.shape[2])] += 1
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro,
            **{k: v * n_micro for k, v in per_mb.items()}, "psgn_split": 0,
            "quantize_int8": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    # bf16 activations and probe gradients at widths that are multiples of
    # 8: every psgn launch takes the tensor cores; attention the plan's
    # routes (all three on the tensor cores)
    plan = plan_of(cfg, torch.bfloat16)
    want_routes = {**{n: {"tc": 0, "fma": 0, plan[n]: want[n]} for n in ROUTED_ATTENTION},
                   "psgn_direct": {"tc": want["psgn_direct"], "split": 0, "fma": 0},
                   "psgn_gram": {"tc": want["psgn_gram"], "split": 0, "fma": 0},
                   "psgn_fused": {"tc": want["psgn_fused"], "split": 0, "fma": 0}}
    if routes != want_routes:
        raise AssertionError(f"routes {routes}, expected {want_routes}")
    print(f"  (c) groups per microbatch: " + "; ".join(
        f"{len(names)} x {tuple(acts[names[0]].shape[1:])} -> "
        f"{tuple(pgrads[names[0]].shape[1:])}" for names in groups.values()))
    print(f"  launches: {counts} (= {2 * layers}, {layers}, {layers}, "
          f"{per_mb['psgn_direct']} direct, {per_mb['psgn_gram']} gram, "
          f"{per_mb['psgn_fused']} fused x {n_micro} microbatches); routes {routes}")
    steady = recs[1:]
    secs = [rec["seconds"] for rec in steady]
    print(f"  per-step ms: median {1e3 * statistics.median(secs):.1f} over steps 2-"
          f"{GRAM_STEPS}; by batch: " + ", ".join(
              f"{m}: {1e3 * statistics.median([x['seconds'] for x in steady if x['batch'] == m]):.1f}"
              for m in sorted({x['batch'] for x in steady})))
    print(f"  frames/s: {sum(rec['batch'] * HUBERT_SEQ for rec in steady) / sum(secs):.1f}; "
          f"peak device memory {peak:.2f} GiB")
    print("  one gram-tier microbatch: " + ", ".join(
        f"{k} {1e3 * v:.1f} ms" for k, v in split.items())
        + f"; total {1e3 * sum(split.values()):.1f} ms")
    del out, params, acts, pgrads, engine
    return counts


def hubert_phase() -> dict[str, dict]:
    """Returns the launch counts of the three encoder paths."""
    phase(f"14. hubert-xlarge, {HUBERT.num_layers} layers, d_model {HUBERT.d_model}, "
          f"{HUBERT.num_heads} heads of hd {HUBERT.resolved_head_dim}, non-causal, bf16, "
          f"remat, attn_impl='pallas': encode, moment-tier and gram-tier DiveBatch on "
          f"{HUBERT_SEQ}-frame sequences")
    cfg = HUBERT.replace(attn_impl="pallas")
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_matmul = sum(p.numel() for p in params.parameters() if p.dim() == 2)
    print(f"  init: {n_params / 1e9:.3f} B parameters ({n_matmul / 1e9:.3f} B in matrix "
          f"products) in {time.perf_counter() - t0:.2f} s")
    paths = {"encoding": encode_phase(cfg, params),
             "encoder training": encoder_train_phase(cfg, params, n_matmul)}
    del params
    torch.cuda.empty_cache()
    phase(f"14c. the gram tier: hubert-xlarge widths at {HUBERT_GRAM_LAYERS} of "
          f"{HUBERT.num_layers} layers, {GRAM_STEPS} steps (m0 4, m_max 8, delta "
          f"{GRAM_DELTA}, a tick every 4 steps)")
    paths["encoder gram-tier training"] = encoder_gram_phase(
        cfg.replace(num_layers=HUBERT_GRAM_LAYERS))
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 15: the encoder, card against CPU
# ---------------------------------------------------------------------------


def encoder_card_vs_cpu_phase() -> None:
    phase("15. hubert-shaped encoder, float32 (2 layers, d_model 320, 4 heads of hd 80, "
          "d_ff 640), then the reference's reduced hubert-xlarge (hd 16): card (kernels) "
          "against CPU (plain versions)")
    for cfg in (HUBERT.replace(num_layers=2, d_model=320, num_heads=4, num_kv_heads=4,
                               d_ff=640, param_dtype="float32", compute_dtype="float32",
                               attn_impl="pallas"),
                get_config("hubert-xlarge", reduced=True).replace(attn_impl="pallas")):
        print(f"  {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
              f"hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}:")
        encoder_card_vs_cpu(cfg)


def encoder_card_vs_cpu(cfg) -> None:
    """``prefill_step`` logits and 6 DiveBatch steps of the float32 encoder
    ``cfg`` on the card and on the CPU from identical weights."""
    seq = 128
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    batch = train_lm.frame_batches(cfg, 5)(0, 3, seq)
    kernels.reset_launch_counts()
    logits = {dev: tf.prefill_step(cfg, model, {k: torch.from_numpy(v).to(dev)
                                                for k, v in batch.items()})[0].cpu()
              for dev, model in (("cuda", card), ("cpu", cpu))}
    attn_routes(kernels.launch_counts(), plan_of(cfg, torch.float32), what="encoding on the card")
    logit_err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    if logit_err > 1e-4:
        raise AssertionError(f"encoder logits differ by {logit_err:.3e} > 1e-4")
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                        granule=2, lr=0.05, tick_every=2)
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, model, program, steps=6, seq_len=seq, micro_batch=2,
                             attn_impl="pallas",
                             batches=train_lm.frame_batches(cfg, 6),
                             log=lambda line: None)
        runs[dev] = (out, kernels.launch_counts())
        if dev == "cuda":
            attn_routes(runs[dev][1], plan_of(cfg, torch.float32),
                        what="encoder training on the card")
    (card_out, card_counts), (cpu_out, cpu_counts) = runs["cuda"], runs["cpu"]
    losses = {d: np.array([x["loss"] for x in o["records"]]) for d, (o, _) in runs.items()}
    rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    if rel > 1e-4:
        raise AssertionError(f"losses differ by {rel:.3e} relative > 1e-4: {losses}")
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    if err > 1e-4:
        raise AssertionError(f"parameters differ by {err:.3e} > 1e-4")
    sched = {d: [x["batch"] for x in o["records"]] for d, (o, _) in runs.items()}
    buckets = {d: o["engine"].stats.buckets for d, (o, _) in runs.items()}
    if sched["cuda"] != sched["cpu"] or buckets["cuda"] != buckets["cpu"]:
        raise AssertionError(f"batch schedules {sched} / buckets {buckets} differ")
    if any(card_counts[k] == 0 for k in ROUTED_ATTENTION) or any(cpu_counts.values()):
        raise AssertionError(f"launches: card {card_counts}, CPU {cpu_counts}")
    print(f"  prefill_step logits within {logit_err:.3e} (tol 1e-4); losses within "
          f"{rel:.3e} relative (tol 1e-4), parameters within {err:.3e} (tol 1e-4); batch "
          f"schedule {sched['cuda']}, buckets {buckets['cuda']} on both; card launches "
          f"{card_counts}")


# ---------------------------------------------------------------------------
# phase 16: scale-out over process groups on the card
# ---------------------------------------------------------------------------

# the hubert-shaped float32 encoder of phase 15 and its DiveBatch program
SMALL_ENCODER = HUBERT.replace(num_layers=2, d_model=320, num_heads=4, num_kv_heads=4,
                               d_ff=640, param_dtype="float32", compute_dtype="float32",
                               attn_impl="pallas")
SMALL_SEQ, SMALL_STEPS = 128, 4
# hubert-xlarge data-parallel: 2 sequences per rank in each microbatch, a
# tick every 2 steps; delta 16 (phase 14b's 0.5 shrinks the batch on these
# random frames) takes the batch from 8 to the cap 16 at the first tick
DP_WORLD, DP_MICRO, DP_M0, DP_M_MAX, DP_DELTA, DP_STEPS = 2, 4, 8, 16, 16.0, 4
DP_DEADLINE_S = 600
# 16b's depth: 24 of hubert-xlarge's 48 layers since phase 33 joined (all
# 48 before), so that the script keeps inside its limit
DP_HUBERT_LAYERS = 24


def small_encoder_run(dev, plan, micro_batch: int) -> dict:
    """``SMALL_STEPS`` DiveBatch steps of ``SMALL_ENCODER`` from phase 15's
    weights (seed 4, drawn on the CPU); losses, batches and parameters."""
    cpu = tf.init_params(SMALL_ENCODER, torch.Generator().manual_seed(4), "cpu")
    model = tf.build(SMALL_ENCODER, dev)
    model.load_state_dict(cpu.state_dict())
    program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5, granule=2,
                                    lr=0.05, tick_every=2)
    out = train_lm.train(SMALL_ENCODER, model, program, steps=SMALL_STEPS,
                         seq_len=SMALL_SEQ, micro_batch=micro_batch, attn_impl="pallas",
                         batches=train_lm.frame_batches(SMALL_ENCODER, 6),
                         log=lambda line: None, plan=plan)
    return {"loss": [r["loss"] for r in out["records"]],
            "batch": [r["batch"] for r in out["records"]],
            "params": [p.detach().cpu().numpy().copy() for p in model.parameters()]}


def param_checksum(model) -> float:
    return float(sum(p.detach().double().sum().item() * (i + 1)
                     for i, p in enumerate(model.parameters())))


class CollectiveClock:
    """Wraps the ``torch.distributed`` collectives ``repro_torch.dist`` calls
    (``all_reduce``, ``all_gather``, and the sharded state's
    ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
    ``all_to_all_single``) to count their bytes and time them between two
    synchronisations of the card.  Bytes are the buffer a call reduces or
    forms: an all-reduce's tensor, a list gather's input, a gather's whole
    output, a reduce-scatter's whole input, an all-to-all's send buffer."""

    #: which positional argument's bytes a call counts
    ARG = {"all_reduce": 0, "all_gather": 1, "all_gather_into_tensor": 0,
           "reduce_scatter_tensor": 1, "all_to_all_single": 1}

    def __init__(self):
        self.ms = {n: 0.0 for n in self.ARG}
        self.bytes = {n: 0 for n in self.ARG}
        self.calls = {n: 0 for n in self.ARG}
        self._inner = {n: getattr(dist, n) for n in self.ms}
        for name, fn in self._inner.items():
            setattr(dist, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[name] += 1e3 * (time.perf_counter() - t0)
            t = args[self.ARG[name]]
            self.bytes[name] += t.numel() * t.element_size()
            self.calls[name] += 1
            return out
        return run

    def snapshot(self) -> dict:
        return {"ms": dict(self.ms), "bytes": dict(self.bytes), "calls": dict(self.calls)}

    def close(self) -> None:
        for name, fn in self._inner.items():
            setattr(dist, name, fn)


def rank_world_one(dev, args) -> dict:
    """16a, NCCL at a world of one: the small encoder without a plan and
    under a rank plan."""
    base = small_encoder_run(dev, None, 2)
    kernels.reset_launch_counts()
    ranked = small_encoder_run(dev, data_plan(dev), 2)
    return {"base": base, "ranked": ranked, "launches": kernels.launch_counts(),
            "routes": kernels.route_counts(), "backend": dist.get_backend()}


def rank_hubert_dp(dev) -> dict:
    """16b, hubert-xlarge at full width, data-parallel over the ranks."""
    cfg = HUBERT.replace(num_layers=DP_HUBERT_LAYERS, attn_impl="pallas")
    plan = data_plan(dev)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    broadcast_([p.data for p in params.parameters()], 0, plan.mesh.group("data"))
    torch.cuda.synchronize()
    bcast_s = time.perf_counter() - t0
    engine = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=DP_MICRO,
                               attn_impl="pallas", dp_size=DP_WORLD, plan=plan)
    clock = CollectiveClock()
    steps = []
    inner = engine.step

    def step(state, batch, lr):
        before = clock.snapshot()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = inner(state, batch, lr)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1)
        after = clock.snapshot()
        steps.append({"batch": int(next(iter(batch.values())).shape[0]), "ms": ms,
                      "loss": loss, "checksum": param_checksum(state.params),
                      "all_reduce_ms": after["ms"]["all_reduce"] - before["ms"]["all_reduce"],
                      "all_reduce_bytes": (after["bytes"]["all_reduce"]
                                           - before["bytes"]["all_reduce"]),
                      "all_reduce_calls": (after["calls"]["all_reduce"]
                                           - before["calls"]["all_reduce"])})
        return state, metrics

    engine.step = step
    program = train_lm.make_program("divebatch", m0=DP_M0, m_max=DP_M_MAX, delta=DP_DELTA,
                                    granule=DP_MICRO, lr=TRAIN_LR, tick_every=2)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        out = train_lm.train(cfg, params, program, steps=DP_STEPS, seq_len=HUBERT_SEQ,
                             micro_batch=DP_MICRO, engine=engine, plan=plan,
                             batches=train_lm.frame_batches(cfg, 1), log=lambda line: None)
    finally:
        clock.close()
    torch.cuda.synchronize()
    return {"steps": steps, "num_micro": [r["num_micro"] for r in out["records"]],
            "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "broadcast_s": bcast_s, "n_params": sum(p.numel() for p in params.parameters()),
            "plan": plan_of(cfg, torch.bfloat16)}


def rank_pod(dev, ckpt_dir: str) -> dict:
    """16c, phase 10's cell with each pod a rank, through ``run_supervised``
    with pod 1 lost at epoch 3."""
    from repro_torch.launch.supervisor import run_supervised

    epochs, trainers = [], []

    def make_trainer(mgr):
        trainer = pod_trainer(dev, devices=rank_devices(dev, per_rank=4), ckpt=mgr)
        inner = trainer.run_epoch

        def run_epoch():
            bsz = trainer.adapt.batch_size
            rec = inner()
            epochs.append(pod_epoch(bsz, trainer.rung.index, rec))
            return rec

        trainer.run_epoch = run_epoch
        trainers.append(trainer)
        return trainer

    clock = CollectiveClock()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run_supervised(make_trainer, 4, [], ckpt_dir, lose_pod=[3])
    finally:
        clock.close()
    torch.cuda.synchronize()
    trainer = trainers[-1]
    cross = sum(steps for _, rung, steps, *_ in epochs
                if trainer.elastic.rungs[rung].pods > 1)
    return {"epochs": epochs, "cross_steps": cross, "launches": kernels.launch_counts(),
            "params": [p.detach().cpu().numpy().copy() for p in trainer.params.parameters()],
            "gather": clock.snapshot(), "wall_s": time.perf_counter() - t0,
            "final_rung": trainer.rung.index}


def rank_scale_out(dev, args) -> dict:
    """16b and 16c on the ranks of one gloo world."""
    plan = data_plan(dev)
    small = small_encoder_run(dev, plan, 2)
    base = small_encoder_run(dev, None, 2) if dist.get_rank() == 0 else None
    dist.barrier()
    hubert = rank_hubert_dp(dev)
    torch.cuda.empty_cache()
    dist.barrier()
    pod = rank_pod(dev, args["ckpt_dir"])
    return {"small": small, "base": base, "hubert": hubert, "pod": pod,
            "backend": dist.get_backend()}


RANK_JOBS = {"world_one": rank_world_one, "scale_out": rank_scale_out}


def rank_main(rank: int, world: int, backend: str, store: str, job: str, args: dict,
              queue, received) -> None:
    """A spawned rank: join the world, run ``job``, report on ``queue``,
    and stay until the parent has ``received`` every result (a CPU tensor
    in a result travels as a shared-memory handle this process serves)."""
    import traceback

    from repro_torch.launch.mesh import init_ranks

    try:
        dev = init_ranks(backend, store=dist.FileStore(store, world), rank=rank,
                         world=world, timeout_s=DP_DEADLINE_S)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = RANK_JOBS[job](dev, args)
        # every library loaded from phase 2's build, none built again
        out["rebuilt"] = {n: r["seconds"] for n, r in _build.BUILD_INFO.items()
                          if r["seconds"] > 0}
        dist.barrier()
        queue.put((rank, out))
        received.wait(DP_DEADLINE_S)
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(job: str, backend: str, world: int, args: dict) -> dict:
    """``{rank: result}`` of ``job`` on ``world`` spawned ranks meeting
    through a ``FileStore`` under ``build/``; every rank is stopped before
    this returns, and any rank's failure raises."""
    import multiprocessing as mproc

    ctx = mproc.get_context("spawn")
    queue = ctx.Queue()
    (ROOT / "build").mkdir(exist_ok=True)
    store = ROOT / "build" / f"store_{job}_{os.getpid()}"
    store.unlink(missing_ok=True)
    received = ctx.Event()
    procs = [ctx.Process(target=rank_main, args=(r, world, backend, str(store), job, args,
                                                 queue, received)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=DP_DEADLINE_S) for _ in procs)
        received.set()
        for p in procs:
            p.join(timeout=120)
    finally:
        received.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        store.unlink(missing_ok=True)
    errors = {r: v for r, v in results.items() if isinstance(v, str)}
    if errors:
        raise AssertionError("\n".join(f"[{backend}, rank {r}] failed:\n{v}"
                                        for r, v in errors.items()))
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"[{backend}] rank exit codes {[p.exitcode for p in procs]}")
    for r, out in results.items():
        if out["rebuilt"]:
            raise AssertionError(f"[{backend}, rank {r}] rebuilt {out['rebuilt']}")
    return results


def bitwise_equal(a: list, b: list) -> bool:
    """Whether two lists of arrays (or tensors) hold the same bits."""
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))
        for x, y in zip(a, b))


def scale_out_phase(pod_final: dict) -> dict[str, dict]:
    """Returns the launch counts of the rank paths, summed over the ranks."""
    phase("16. scale-out over process groups: ranks spawned on the one card")
    t_phase = time.perf_counter()
    # (a) NCCL at a world of one
    t0 = time.perf_counter()
    one = spawn_ranks("world_one", "nccl", 1, {})[0]
    tag = f"[{one['backend']}, world 1, rank 0]"
    same = ([float.hex(x) for x in one["base"]["loss"]]
            == [float.hex(x) for x in one["ranked"]["loss"]]
            and one["base"]["batch"] == one["ranked"]["batch"]
            and bitwise_equal(one["base"]["params"], one["ranked"]["params"]))
    if not same:
        raise AssertionError(f"{tag} under a plan: losses {one['ranked']['loss']} against "
                             f"{one['base']['loss']}, or parameters differ")
    attn_routes(one["launches"], plan_of(SMALL_ENCODER, torch.float32),
                what=f"{tag} the small encoder", routes=one["routes"])
    print(f"  (a) {tag} the hubert-shaped float32 encoder, {SMALL_STEPS} DiveBatch steps "
          f"under a rank plan (every microbatch's gradient all-reduced): losses "
          f"{[round(x, 6) for x in one['ranked']['loss']]}, batches "
          f"{one['ranked']['batch']}, the run without a plan's to the bit, parameters "
          f"too; launches {one['launches']}; {time.perf_counter() - t0:.1f} s with the "
          f"spawn")
    # (b), (c) gloo at a world of two on the one card
    t0 = time.perf_counter()
    ckpt_dir = ckpt_root("scale_out")
    try:
        res = spawn_ranks("scale_out", "gloo", DP_WORLD, {"ckpt_dir": ckpt_dir})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    tags = {r: f"[{res[r]['backend']}, world {DP_WORLD}, rank {r}]" for r in res}
    # (b) the small encoder on the ranks against one process
    base = res[0]["base"]
    for r in res:
        got = res[r]["small"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], base["loss"]))
        err = max(float(np.abs(a - b).max()) for a, b in zip(got["params"], base["params"]))
        if got["batch"] != base["batch"] or rel > 1e-5 or err > 1e-5:
            raise AssertionError(f"{tags[r]} small encoder: batches {got['batch']} against "
                                 f"{base['batch']}, losses within {rel:.3e} (tol 1e-5), "
                                 f"parameters within {err:.3e} (tol 1e-5)")
        print(f"  (b) {tags[r]} the small encoder data-parallel (1 sequence per rank per "
              f"microbatch) against one process: batches {got['batch']}, losses within "
              f"{rel:.3e} relative (tol 1e-5), parameters within {err:.3e} (tol 1e-5)")
    # (b) hubert-xlarge at full width
    hub = {r: res[r]["hubert"] for r in res}
    sched = {r: [s["batch"] for s in h["steps"]] for r, h in hub.items()}
    if any(v != [8, 8, 16, 16] for v in sched.values()):
        raise AssertionError(f"hubert schedules {sched}, expected [8, 8, 16, 16]")
    checks = [[s["checksum"] for s in h["steps"]] for h in hub.values()]
    if any(c != checks[0] for c in checks):
        raise AssertionError(f"the replicas differ: parameter checksums {checks}")
    layers = DP_HUBERT_LAYERS
    for r, h in hub.items():
        if not all(np.isfinite(s["loss"]) for s in h["steps"]):
            raise AssertionError(f"{tags[r]} non-finite loss {h['steps']}")
        n_micro = sum(h["num_micro"])
        want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
                "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
        if h["launches"] != want:
            raise AssertionError(f"{tags[r]} launches {h['launches']}, expected {want}")
        if any(h["plan"][n] != "tc" for n in ROUTED_ATTENTION):
            raise AssertionError(f"{tags[r]} the plan {h['plan']} is not the tensor cores'")
        attn_routes(h["launches"], h["plan"], what=f"{tags[r]} hubert", routes=h["routes"])
        print(f"  (b) {tags[r]} hubert-xlarge, {layers} layers, bf16, {h['n_params'] / 1e9:.3f} "
              f"B parameters (rank 0's broadcast to the others in {h['broadcast_s']:.2f} s), "
              f"for_lm(dp_size={DP_WORLD}), {DP_MICRO // DP_WORLD} sequences of "
              f"{HUBERT_SEQ} frames per rank per microbatch:")
        for i, st in enumerate(h["steps"]):
            print(f"    step {i + 1}: batch {st['batch']} ({h['num_micro'][i]} microbatches), "
                  f"loss {st['loss']:.5f}, {st['ms']:.1f} ms; all-reduce "
                  f"{st['all_reduce_calls']} calls, {st['all_reduce_bytes'] / 1e9:.3f} GB, "
                  f"{st['all_reduce_ms']:.1f} ms; parameter checksum {st['checksum']:.6e}")
        by_batch = {m: statistics.median(s["ms"] for s in h["steps"] if s["batch"] == m)
                    for m in sorted(set(sched[r]))}
        print(f"    launches {h['launches']} (= {2 * layers}, {layers}, {layers} x {n_micro} "
              f"microbatches), all three on tc; step ms by batch (median) "
              + ", ".join(f"{m}: {v:.1f}" for m, v in by_batch.items())
              + f"; peak device memory {h['peak_gib']:.2f} GiB")
    print(f"  (b) the replicas' parameter checksums are equal at every step: "
          f"{checks[0] == checks[1]}; the numbers are gloo's through the host, on one card: "
          f"no yardstick for NCCL across cards")
    # (c) the pod cell with each pod a rank
    pods = {r: res[r]["pod"] for r in res}
    first = pods[0]
    want_epochs = pod_final["epochs"]
    if first["epochs"] != want_epochs:
        raise AssertionError(f"pod ranks: epochs {first['epochs']} against phase 10's "
                             f"{want_epochs}")
    if pods[1]["epochs"] != want_epochs[:3]:
        raise AssertionError(f"pod 1's rank: epochs {pods[1]['epochs']}, expected phase "
                             f"10's first 3")
    if not bitwise_equal(first["params"], [p.numpy() for p in pod_final["params"]]):
        raise AssertionError("pod ranks: parameters differ from phase 10's")
    if first["final_rung"] != 2:
        raise AssertionError(f"pod ranks: final rung {first['final_rung']}")
    n_leaves = len(pod_final["params"])
    for r, pd in pods.items():
        want = {k: 0 for k in pd["launches"]} | {"quantize_int8": n_leaves * pd["cross_steps"]}
        if pd["launches"] != want or pd["cross_steps"] == 0:
            raise AssertionError(f"{tags[r]} pod launches {pd['launches']}, expected {want}")
    for bsz, rung, steps, train_loss, val_loss, delta in first["epochs"]:
        print(f"  (c) {tags[0]} epoch: batch {bsz}, rung {rung}, {steps} steps, train loss "
              f"{train_loss:.6f}, val loss {val_loss:.6f}, Delta {delta:.6f}")
    g = first["gather"]
    numel = sum(int(p.numel()) for p in pod_final["params"])
    print(f"  (c) schedule (batch, rung, steps), losses, Delta and parameters equal phase "
          f"10's to the bit, pod 1 lost and the demotion 3 -> 2 through run_supervised "
          f"included (pod 1's rank left after epoch 3 with phase 10's first 3 epochs); "
          f"quantize_int8 launches per rank {[pods[r]['launches']['quantize_int8'] for r in pods]}"
          f" (= {n_leaves} leaves x {first['cross_steps']} cross-pod steps); all-gather "
          f"{g['calls']['all_gather']} calls, {g['bytes']['all_gather']} bytes sent by rank "
          f"0 ({numel} int8 codes + float32 scales, losses and moment terms a step), "
          f"{g['ms']['all_gather']:.1f} ms in all; {first['wall_s']:.1f} s")
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s (the gloo spawn {spawn_s:.1f} s)")
    return {"encoder dp training (ranks)": {
                k: sum(res[r]["hubert"]["launches"][k] for r in res) for k in hub[0]["launches"]},
            "pod training (ranks)": {
                k: sum(res[r]["pod"]["launches"][k] for r in res) for k in pods[0]["launches"]}}


# ---------------------------------------------------------------------------
# phase 17: the dense family at full width
# ---------------------------------------------------------------------------

GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_SEQ, GEMMA_TRAIN_STEPS = 4, 8192, 6
LLAMA_LAYERS = 4
INTERN_BATCH, INTERN_SEQ, INTERN_DECODE = 4, 1024, 16


def gemma_requests(vocab: int, seed: int = 1) -> list[Request]:
    """6 greedy requests of 32 new tokens: two prompts of about 5000 tokens
    (they pad to 8192, so each 4096-key ring wraps and the window cuts keys
    in the chunk kernel), three of 64-700, and an exact repeat of the
    second long prompt, last (a full-prompt hit replaying its cached
    rings)."""
    r = np.random.default_rng(seed)
    reqs = [r.integers(1, vocab, size=n) for n in (4950, 64, 700, 333, 5050)]
    reqs.append(reqs[-1].copy())
    return [Request(prompt=p.astype(np.int32), max_new_tokens=32) for p in reqs]


def init_timed(cfg, seed: int = 0):
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    gib = sum(p.numel() * p.element_size() for p in params.parameters()) / 2**30
    print(f"  init: {n / 1e9:.3f} B parameters ({gib:.2f} GiB) in "
          f"{time.perf_counter() - t0:.2f} s")
    return params, gib


def free() -> None:
    """Return the freed model's blocks to the card before the next one
    (tensors held only by reference cycles included)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def gemma_serve_phase() -> dict:
    """17a: gemma2-27b at all 46 layers, served; exactly 23 paged decode
    launches per decode step (the global layers; the local layers' rings
    decode on the plain lane, as the reference's XLA does) and 46 chunk
    launches per prefill chunk."""
    cfg = GEMMA.replace(attn_impl="pallas")
    print(f"  (a) {cfg.name}, {cfg.num_layers} layers ({len(tf.paged_positions(cfg))} "
          f"of {cfg.period} positions paged: {cfg.repeats} global layers, {cfg.repeats} "
          f"sliding-window ones, window {cfg.window}), softcaps {cfg.attn_softcap:g} / "
          f"{cfg.final_softcap:g}, bf16:")
    params, w_gib = init_timed(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    block_bytes = 2 * cfg.repeats * 16 * kv * hd * 2
    ring_gib = 2 * cfg.repeats * cfg.window * kv * hd * 2 / 2**30  # one slot's rings
    reqs = gemma_requests(cfg.vocab_size)
    # the chunk launches of the windowed form (the local layers) apart: the
    # wrapper's count read around each call that passes a window
    windowed = [0]
    orig_fwd = kattn.chunk_attention_fwd

    def fwd_tallied(*a, window=None, **kw):
        before = kattn.chunk_attention.launches
        res = orig_fwd(*a, window=window, **kw)
        if window is not None:
            windowed[0] += kattn.chunk_attention.launches - before
        return res

    kattn.chunk_attention_fwd = fwd_tallied
    try:
        out = serve_checked(cfg, params, reqs, max_slots=GEMMA_SLOTS, max_seq=GEMMA_MAX_SEQ,
                            block_size=16, prompt_granule=16, prefill_chunk=GEMMA_CHUNK,
                            pool_blocks=(4 << 30) // block_bytes, prefix_sharing=True)
    finally:
        kattn.chunk_attention_fwd = orig_fwd
    st = out["engine"].stats
    if st.shared_prefill_hits != 1 or st.shared_blocks != GEMMA_MAX_SEQ // 16:
        raise AssertionError(f"the repeated prompt was not a full-prompt hit: hits "
                             f"{st.shared_prefill_hits}, blocks {st.shared_blocks}")
    times = serve_report(out, cfg, reqs, per_chunk=cfg.num_layers, per_step=cfg.repeats)
    if windowed[0] != cfg.repeats * st.prefill_chunks:
        raise AssertionError(f"windowed chunk launches {windowed[0]}, expected "
                             f"{cfg.repeats} x {st.prefill_chunks} chunks")
    print(f"  windowed chunk launches (the local layers): {windowed[0]} = {cfg.repeats} x "
          f"{st.prefill_chunks} chunks")
    # the repeat decodes beside other neighbours than its original did, so
    # bf16 near-ties may part them: printed, not held
    same = out["results"][-1].tokens.tolist() == out["results"][-2].tokens.tolist()
    print(f"  the full-prompt hit: {st.shared_blocks} blocks adopted, its 32 tokens "
          f"equal its original's: {same}")
    cached = len({q.prompt.tobytes() for q in reqs})
    reckon = w_gib + pool_gib(out["engine"]) + ring_gib * (2 * GEMMA_SLOTS + cached)
    print(f"  memory reckoned: weights {w_gib:.2f} + pool {pool_gib(out['engine']):.2f} + "
          f"rings {ring_gib:.3f} GiB x ({GEMMA_SLOTS} slots + up to {GEMMA_SLOTS} prefill "
          f"rows + {cached} cached prompt rows) = {reckon:.2f} GiB; measured peak "
          f"{out['peak']:.2f} GiB")
    counts = {**out["counts"], "chunk_attention windowed": windowed[0]}
    del out, params
    free()
    return {"counts": counts, **times}


def dense_serve_phase(cfg, label: str) -> dict:
    """17b: ``cfg`` served on phase 4's trace and engine settings; one chunk
    launch per layer per prefill chunk and one paged decode launch per
    layer per decode step."""
    cfg = cfg.replace(attn_impl="pallas")
    print(f"  (b) {label}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of hd {cfg.resolved_head_dim} "
          f"(n_rep {cfg.num_heads // cfg.num_kv_heads}), bf16:")
    params, _ = init_timed(cfg)
    reqs = slice_requests(cfg.vocab_size)
    out = serve_checked(cfg, params, reqs, max_slots=8, max_seq=2048, block_size=16,
                        prompt_granule=16, prefill_chunk=256, prefix_sharing=True)
    if out["engine"].stats.shared_blocks == 0:
        raise AssertionError("the shared prefix was not adopted")
    times = serve_report(out, cfg, reqs, per_chunk=cfg.num_layers, per_step=cfg.num_layers)
    counts = out["counts"]
    del out, params
    free()
    return {"counts": counts, **times}


def intern_phase() -> dict:
    """17c: internvl2-1b at full depth: ``prefill_step`` on 4 x 1024
    embeddings (24 chunk launches), 16 lockstep ``decode_step``s on its
    dense cache with (4, 1, 896) embeddings (no launch: the dense cache
    decodes on the plain lane, as the reference's XLA), finite logits; the
    prompt's logits against the plain dense lane (``DENSE_GAP_TOL``)."""
    cfg = get_config("internvl2-1b").replace(attn_impl="pallas")
    print(f"  (c) {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of hd {cfg.resolved_head_dim}, an "
          f"embedding frontend, bf16:")
    params, _ = init_timed(cfg)
    r = np.random.default_rng(7)
    emb = torch.from_numpy(r.standard_normal(
        (INTERN_BATCH, INTERN_SEQ, cfg.d_model)).astype(np.float32)).to("cuda")
    steps = torch.from_numpy(r.standard_normal(
        (INTERN_DECODE, INTERN_BATCH, 1, cfg.d_model)).astype(np.float32)).to("cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    (logits, cache), pre_s = timed_s(lambda: tf.prefill_step(cfg, params, {"embeddings": emb}))
    pre = kernels.launch_counts()
    if pre != {**{k: 0 for k in pre}, "chunk_attention": cfg.num_layers}:
        raise AssertionError(f"prefill launches {pre}, expected {cfg.num_layers} chunk")
    attn_routes(pre, plan_of(cfg, torch.bfloat16), what="prefill_step")
    if logits.shape != (INTERN_BATCH, 1, cfg.vocab_size) or int(cache["len"]) != INTERN_SEQ:
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, len {cache['len']}")
    kernels.reset_launch_counts()
    dec_s, outs = [], [logits]
    for i in range(INTERN_DECODE):
        (lg, cache), secs = timed_s(lambda: tf.decode_step(cfg, params, cache, steps[i]))
        dec_s.append(secs)
        outs.append(lg)
    dec = kernels.launch_counts()
    if any(dec.values()):
        raise AssertionError(f"dense-cache decode launched {dec}")
    if not all(bool(torch.isfinite(x).all()) for x in outs) or int(cache["len"]) != \
            INTERN_SEQ + INTERN_DECODE:
        raise AssertionError("non-finite logits or a wrong length after decode")
    dense = tf.prefill_step(cfg.replace(attn_impl="dense"), params, {"embeddings": emb})[0]
    gap = (logits - dense).abs().max().item()
    scale = dense.abs().max().item()
    if not gap <= DENSE_GAP_TOL * scale:
        raise AssertionError(f"prefill logits against the dense lane: gap {gap:.4e} > "
                             f"{DENSE_GAP_TOL} x {scale:.4e}")
    print(f"  prefill_step on {INTERN_BATCH} x {INTERN_SEQ} embeddings: {1e3 * pre_s:.1f} ms "
          f"(host clock, first call); launches {pre}; then {INTERN_DECODE} decode steps "
          f"on the dense cache: median {1e3 * statistics.median(dec_s[1:]):.2f} ms, "
          f"launches {dec} (the plain lane); logits finite; the prompt's logits against "
          f"the dense lane: largest gap {gap:.4e}, {gap / scale:.3e} of the largest "
          f"(tol {DENSE_GAP_TOL})")
    del params, cache, outs, dense, logits
    free()
    return pre


def gemma_train_phase() -> dict:
    """17d: gemma2-27b widths at 4 of its 46 layers, S 8192 (its context
    length: the window of 4096 cuts the local layers), micro batch 1, remat,
    a tick-fired DiveBatch program, 6 steps: every loss finite, exactly 8
    chunk, 4 dq and 4 dk/dv launches per microbatch, all on the tensor
    cores."""
    cfg = GEMMA.replace(num_layers=GEMMA_TRAIN_LAYERS, attn_impl="pallas")
    print(f"  (d) {cfg.name} widths at {cfg.num_layers} of 46 layers, S {GEMMA_TRAIN_SEQ}, "
          f"window {cfg.window}, softcaps {cfg.attn_softcap:g} / {cfg.final_softcap:g}, "
          f"bf16, remat, micro batch 1:")
    params, _ = init_timed(cfg)
    n_matmul = sum(p.numel() for p in params.parameters()) - params.embed.weight.numel()
    program = train_lm.make_program("divebatch", m0=2, m_max=4, delta=0.5, granule=1,
                                    lr=0.02, tick_every=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=GEMMA_TRAIN_STEPS,
                         seq_len=GEMMA_TRAIN_SEQ, micro_batch=1, attn_impl="pallas",
                         log=lambda line: None)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    recs = out["records"]
    for rec in recs:
        tick = (f"; tick: Delta {rec['diversity']:.6f}, batch {rec['batch']} -> "
                f"{rec['next_batch']}" if "diversity" in rec else "")
        print(f"    step {rec['step']}: batch {rec['batch']} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms{tick}")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="training")
    s, hd, h = GEMMA_TRAIN_SEQ, cfg.resolved_head_dim, cfg.num_heads
    local = sum(min(i + 1, cfg.window) for i in range(s))
    pairs = (local + s * (s + 1) // 2) * cfg.repeats

    def model_flops(batch: int) -> float:
        # 6 N per token for the products, plus the attention pairs: 2
        # products forward and 4 backward of 2 hd per (row, key) pair a head
        return 6 * n_matmul * batch * s + 12 * hd * h * batch * pairs

    steady = recs[1:]
    secs = [x["seconds"] for x in steady]
    flops = sum(model_flops(x["batch"]) for x in steady)
    step_ms = {m: 1e3 * statistics.median([x["seconds"] for x in steady if x["batch"] == m])
               for m in sorted({x["batch"] for x in steady})}
    print(f"  launches {counts} (= {2 * layers}, {layers}, {layers} x {n_micro} "
          f"microbatches), attention routes {attention_routes()}; step ms by batch "
          f"(median, steps 2-{GEMMA_TRAIN_STEPS}) " + ", ".join(
              f"{m}: {v:.1f}" for m, v in step_ms.items())
          + f"; {sum(x['batch'] * s for x in steady) / sum(secs):.1f} tokens/s; "
          f"{flops / sum(secs) / 1e12:.1f} TFLOP/s of model FLOPs = "
          f"{100 * flops / sum(secs) / PEAK_BF16:.1f}% of 989; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out, params
    free()
    return {"counts": counts, "step_ms": step_ms}


def dense_phase() -> dict[str, dict]:
    phase("17. the dense family at full width (weights from a seeded generator, bf16, "
          "attn_impl='pallas'; each model freed before the next)")
    t0 = time.perf_counter()
    paths = {"gemma2-27b serving": gemma_serve_phase()["counts"],
             "qwen2-7b serving": dense_serve_phase(get_config("qwen2-7b"),
                                                   "qwen2-7b, all 28 layers")["counts"],
             "llama3-405b serving": dense_serve_phase(
                 LLAMA.replace(num_layers=LLAMA_LAYERS),
                 f"llama3-405b at full width, {LLAMA_LAYERS} of 126 layers (a depth cut: "
                 f"126 layers are 810 GB)")["counts"],
             "internvl2-1b prefill_step": intern_phase(),
             "gemma2-27b training": gemma_train_phase()["counts"]}
    print(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    return paths


# ---------------------------------------------------------------------------
# phase 18: the dense family, card against CPU
# ---------------------------------------------------------------------------


def dense_first_logits(cfg, card, cpu, toks) -> float:
    """One whole-prompt chunk into fresh pools and rings on both devices:
    the largest gap of the last position's logits."""
    logits = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        pages = tf.init_pages(cfg, 8, 16, device=dev)
        row = tf.init_cache(cfg, 1, 128, skip=tf.paged_positions(cfg), device=dev)
        row["len"] = torch.zeros(1, dtype=torch.int32, device=dev)
        out, _, _ = tf.prefill_chunk(cfg, model, row, pages, {"tokens": toks.to(dev)},
                                     0, torch.zeros(0, dtype=torch.long, device=dev),
                                     torch.arange(1, 4, device=dev))
        logits[dev] = out.cpu()
    return (logits["cuda"] - logits["cpu"]).abs().max().item()


def reduced_serve_card_vs_cpu(arch: str, r):
    """The reference's reduced ``arch`` (float32) with identical weights on
    the card and the CPU: a whole-prompt chunk's first logits within 1e-4,
    then one greedy trace with a full-prompt hit through ``ServeEngine``,
    tokens identical, one chunk launch per attention layer per prefill
    chunk and one paged decode per global layer per decode step (none for
    an attention-free model).  Returns the config and both models."""
    cfg = get_config(arch, reduced=True).replace(attn_impl="pallas")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    err = dense_first_logits(
        cfg, card, cpu, torch.from_numpy(r.integers(1, cfg.vocab_size, size=(1, 48))))
    if err > 1e-4:
        raise AssertionError(f"{arch}: first logits differ by {err:.3e} > 1e-4")
    prompts = [r.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (7, 40, 23, 64)]
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts + [prompts[1]]]
    kw = dict(max_slots=4, max_seq=128, block_size=16, prompt_granule=16,
              prefill_chunk=32)
    kernels.reset_launch_counts()
    card_eng = ServeEngine(cfg, card, device="cuda", **kw)
    out_card = card_eng.generate(reqs)
    launched = kernels.launch_counts()
    out_cpu = ServeEngine(cfg, cpu, device="cpu", **kw).generate(reqs)
    tc = [o.tokens.tolist() for o in out_card]
    if tc != [o.tokens.tolist() for o in out_cpu]:
        raise AssertionError(f"{arch}: card and CPU tokens differ")
    st = card_eng.stats
    n_attn = cfg.repeats * sum(kind != "mamba" for kind in cfg.pattern)
    want_chunk = st.prefill_chunks * n_attn
    want_dec = st.steps * cfg.repeats * len(tf.paged_positions(cfg))
    if (launched["chunk_attention"], launched["paged_decode_attention"]) != \
            (want_chunk, want_dec) or st.shared_prefill_hits != 1:
        raise AssertionError(f"{arch}: launches {launched}, expected {want_chunk} "
                             f"chunk and {want_dec} decode; hits {st.shared_prefill_hits}")
    if n_attn:
        attn_routes(launched, plan_of(cfg, torch.float32), what="float32 serving")
    print(f"  {arch}: first logits max abs diff {err:.3e} (tol 1e-4); tokens "
          f"identical over {sum(len(t) for t in tc)} tokens (a full-prompt hit "
          f"included); card launches {launched}")
    return cfg, card, cpu


def dense_card_vs_cpu_phase() -> None:
    phase("18. the reference's reduced dense configs (hd 16, float32): card (kernels) "
          "against CPU (plain versions)")
    r = np.random.default_rng(18)
    for arch in ("qwen2-7b", "llama3-405b", "gemma2-27b"):
        reduced_serve_card_vs_cpu(arch, r)
    # internvl2: prefill_step then lockstep decode on the dense cache
    cfg = get_config("internvl2-1b", reduced=True).replace(attn_impl="pallas")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    emb = torch.from_numpy(r.standard_normal((2, 48, cfg.d_model)).astype(np.float32))
    nxt = torch.from_numpy(r.standard_normal((8, 2, 1, cfg.d_model)).astype(np.float32))
    logs = {}
    kernels.reset_launch_counts()
    for dev, model in (("cuda", card), ("cpu", cpu)):
        lg, cache = tf.prefill_step(cfg, model, {"embeddings": emb.to(dev)})
        seq = [lg.cpu()]
        for i in range(8):
            lg, cache = tf.decode_step(cfg, model, cache, nxt[i].to(dev))
            seq.append(lg.cpu())
        logs[dev] = torch.stack(seq)
        if dev == "cuda":
            launched = kernels.launch_counts()
    err = (logs["cuda"] - logs["cpu"]).abs().max().item()
    same = torch.equal(logs["cuda"].argmax(-1), logs["cpu"].argmax(-1))
    if err > 1e-4 or not same or launched["chunk_attention"] != cfg.num_layers:
        raise AssertionError(f"internvl2-1b: logits differ by {err:.3e} (tol 1e-4), argmax "
                             f"equal {same}, launches {launched}")
    print(f"  internvl2-1b: prefill_step and 8 dense-cache decode steps on embeddings: "
          f"logits within {err:.3e} (tol 1e-4), the same argmax at every step; card "
          f"launches {launched}")
    print("  gemma2-27b (reduced: window 8 of S 64, softcaps 50 / 30) trains:")
    lm_train_card_vs_cpu(get_config("gemma2-27b", reduced=True).replace(attn_impl="pallas"))


# ---------------------------------------------------------------------------
# phase 19: the MoE family at full width
# ---------------------------------------------------------------------------

DBRX_SERVE_LAYERS, KIMI_SERVE_LAYERS, DBRX_TRAIN_LAYERS, MOE_TRAIN_STEPS = 8, 2, 1, 6
MOE_TOKENS = 256  # phase 19d's tokens


@contextlib.contextmanager
def moe_drop_tally(params):
    """Each MoE layer's drops counted apart for prefill chunks and decode
    steps: yields ``{"prefill": [stats per layer], "decode": [...]}``, the
    per-layer ``MoE.stats`` dicts the wrapped ``tf.prefill_chunk`` and
    ``tf.decode_step`` switch to before each call (a hybrid's dense FFNs
    count nothing)."""
    layers = [blk.ffn for blk in params.blocks if isinstance(blk.ffn, moe.MoE)]
    tally = {"prefill": [{} for _ in layers], "decode": [{} for _ in layers]}
    orig_decode, orig_chunk = tf.decode_step, tf.prefill_chunk

    def counting(kind, fn):
        def call(*a, **kw):
            for layer, st in zip(layers, tally[kind]):
                layer.stats = st
            return fn(*a, **kw)
        return call

    tf.decode_step = counting("decode", orig_decode)
    tf.prefill_chunk = counting("prefill", orig_chunk)
    try:
        yield tally
    finally:
        tf.decode_step, tf.prefill_chunk = orig_decode, orig_chunk
        for layer in layers:
            layer.stats = None


def moe_shares(stats: list[dict], top_k: int) -> tuple[list[float], list[float]]:
    """Per layer: the share of assignments the capacity dropped, and the
    share of tokens whose first expert is their group's commonest first
    expert.  A layer that counted nothing raises."""
    if not all(stats):
        raise AssertionError(f"a MoE layer counted no call: {stats}")
    return ([int(st["dropped"]) / st["assignments"] for st in stats],
            [int(st["first_top"]) * top_k / st["assignments"] for st in stats])


def weight_bytes(params, skip=("embed",)) -> int:
    return sum(p.numel() * p.element_size() for n, p in params.named_parameters()
               if not n.startswith(skip))


def moe_serve_phase(cfg, label: str, pool_bytes: int) -> dict:
    """19a/b: ``cfg`` served on phase 4's trace and engine settings with a
    pool of ``pool_bytes``; one chunk launch per layer per prefill chunk,
    one paged decode launch per layer per decode step; the capacity's drop
    share per layer in prefill and decode; the peak beside the reckoning
    (weights and pool); the decode step beside the HBM floor of the
    capacity form, which reads every expert's weights each step."""
    cfg = cfg.replace(attn_impl="pallas")
    print(f"  ({label}) {cfg.name} at full width, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of hd "
          f"{cfg.resolved_head_dim} (n_rep {cfg.num_heads // cfg.num_kv_heads}), "
          f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, top {cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor:g}, bf16:")
    params, w_gib = init_timed(cfg)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    block_bytes = 2 * cfg.num_layers * 16 * kv * hd * 2
    reqs = slice_requests(cfg.vocab_size)
    with moe_drop_tally(params) as tally:
        out = serve_checked(cfg, params, reqs, max_slots=8, max_seq=2048, block_size=16,
                            prompt_granule=16, prefill_chunk=256, prefix_sharing=True,
                            pool_blocks=pool_bytes // block_bytes)
        shares = {k: moe_shares(v, cfg.top_k) for k, v in tally.items()}
    if out["engine"].stats.shared_blocks == 0:
        raise AssertionError("the shared prefix was not adopted")
    times = serve_report(out, cfg, reqs, per_chunk=cfg.num_layers, per_step=cfg.num_layers)
    for kind, (dropped, first) in shares.items():
        print(f"  capacity drops in {kind} (factor {cfg.capacity_factor:g}), per layer: "
              + ", ".join(f"{100 * x:.2f}%" for x in dropped))
        print(f"  tokens on their group's commonest first expert in {kind}, per layer: "
              + ", ".join(f"{100 * x:.2f}%" for x in first)
              + f" (1 / E = {100 / cfg.num_experts:.2f}%)")
    experts = sum(nbytes(blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_out) for blk in params.blocks)
    floor_ms = 1e3 * weight_bytes(params) / PEAK_BYTES
    print(f"  the capacity form reads every expert each step: {experts / 1e9:.2f} GB of "
          f"experts ({experts / cfg.num_layers / 1e9:.2f} GB a layer), "
          f"{1e3 * experts / PEAK_BYTES:.2f} ms of HBM; every weight but the embedding "
          f"{floor_ms:.2f} ms: the decode step's floor, beside its median "
          f"{times['decode_ms']:.2f} ms")
    reckon = w_gib + pool_gib(out["engine"])
    print(f"  memory reckoned: weights {w_gib:.2f} + pool {pool_gib(out['engine']):.2f} = "
          f"{reckon:.2f} GiB; measured peak {out['peak']:.2f} GiB")
    counts = out["counts"]
    del out, params
    free()
    return {"counts": counts, "floor_ms": floor_ms, **times}


def moe_train_phase() -> dict:
    """19c: dbrx-132b widths at 1 of its 40 layers, S 4096, micro batch 1,
    remat, ``for_lm(moe_groups=1)`` on the moment tier, sgd with momentum
    0.9, a DiveBatch program (m0 2, m_max 4), 6 steps: finite losses, each
    step's ce_loss and moe_aux, exactly 2 chunk, 1 dq and 1 dk/dv launches
    per microbatch on the tensor cores; model FLOP/s (6 N_active S plus
    attention); the peak beside the reckoning."""
    cfg = DBRX.replace(num_layers=DBRX_TRAIN_LAYERS, attn_impl="pallas")
    print(f"  (c) {cfg.name} widths at {cfg.num_layers} of 40 layers, S {MOE_TRAIN_SEQ}, "
          f"bf16, remat, micro batch 1, for_lm(moe_groups=1):")
    params, _ = init_timed(cfg)
    n = sum(p.numel() for p in params.parameters())
    blk = params.blocks[0]
    expert = sum(getattr(blk.ffn, k).numel() for k in ("w_gate", "w_up", "w_out"))
    # the products a token runs: attention, the router, top_k of E experts, the head
    n_active = (n - params.embed.weight.numel() - expert * cfg.num_layers
                + expert * cfg.num_layers * cfg.top_k // cfg.num_experts)
    largest = max(p.numel() for p in params.parameters())
    program = train_lm.make_program("divebatch", m0=2, m_max=4, delta=0.5, granule=1,
                                    lr=0.02, tick_every=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=MOE_TRAIN_STEPS, seq_len=MOE_TRAIN_SEQ,
                         micro_batch=1, attn_impl="pallas", moe_groups=1,
                         log=lambda line: None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernels.launch_counts()
    recs = out["records"]
    for rec in recs:
        tick = (f"; tick: Delta {rec['diversity']:.6f}, batch {rec['batch']} -> "
                f"{rec['next_batch']}" if "diversity" in rec else "")
        print(f"    step {rec['step']}: batch {rec['batch']} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, ce_loss {rec['ce_loss']:.5f}, "
              f"moe_aux {rec['moe_aux']:.5f}, {1e3 * rec['seconds']:.1f} ms{tick}")
    if not all(np.isfinite([rec[k] for rec in recs for k in ("loss", "ce_loss", "moe_aux")])):
        raise AssertionError(f"non-finite loss: {recs}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="training")
    s, hd, h = MOE_TRAIN_SEQ, cfg.resolved_head_dim, cfg.num_heads
    per_seq = 6 * n_active * s + 12 * hd * h * layers * s * (s + 1) // 2
    steady = recs[1:]
    secs = [x["seconds"] for x in steady]
    flops = per_seq * sum(x["batch"] for x in steady)
    step_ms = {m: 1e3 * statistics.median([x["seconds"] for x in steady if x["batch"] == m])
               for m in sorted({x["batch"] for x in steady})}
    # weights, gradients and momenta in bf16, grad_sum and the microbatch
    # accumulator in float32; sgd's update forms the largest tensor's
    # float32 momentum copy and its product (8 bytes an element)
    reckon = (14 * n + 8 * largest) / 2**30
    print(f"  launches {counts} (= {2 * layers}, {layers}, {layers} x {n_micro} "
          f"microbatches), attention routes {attention_routes()}; step ms by batch "
          f"(median, steps 2-{MOE_TRAIN_STEPS}) " + ", ".join(
              f"{m}: {v:.1f}" for m, v in step_ms.items())
          + f"; {sum(x['batch'] * s for x in steady) / sum(secs):.1f} tokens/s; "
          f"{per_seq:.4e} model FLOP a sequence ({n_active / 1e9:.3f} B active of "
          f"{n / 1e9:.3f} B); {flops / sum(secs) / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / sum(secs) / PEAK_BF16:.1f}% of 989")
    print(f"  memory reckoned: 14 B x {n / 1e9:.3f} B parameters + 8 B x {largest / 1e9:.3f} B "
          f"(the largest tensor's float32 update) = {reckon:.2f} GiB; measured peak "
          f"{peak:.2f} GiB")
    del out, params
    free()
    return {"counts": counts, "step_ms": step_ms, "peak": peak}


def moe_kept_plain(layer, x, top_k: int, factor: float) -> tuple[torch.Tensor, int]:
    """The MoE layer's output as a plain loop: routing by ``torch.topk``
    (float32 softmax, renormalised), then expert by expert its assignments
    in token order, the first C kept, each token's weighted outputs summed
    in float32.  Returns (output, dropped assignments)."""
    t = x.shape[0]
    num_e = layer.w_gate.shape[0]
    probs = torch.softmax(x.float() @ layer.router.weight.float().t(), dim=-1)
    w, ex = torch.topk(probs, top_k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    cap = max(int(t * top_k * factor / num_e) + 1, 4)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    kept = 0
    for e in range(num_e):
        tok, j = (ex == e).nonzero(as_tuple=True)
        tok, j = tok[:cap], j[:cap]
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(xe @ layer.w_gate[e]) * (xe @ layer.w_up[e])
        y.index_add_(0, tok, (h @ layer.w_out[e]).float() * w[tok, j, None])
        kept += tok.numel()
    return y, t * top_k - kept


def moe_layer_phase() -> None:
    """19d: one dbrx-132b layer and one kimi-k2 layer at full width, bf16,
    256 tokens: ``moe_apply`` at capacity E / top_k (nothing drops) against
    ``moe_reference``, and at 1.25 against the plain loop over the kept
    assignments, the dropped counts equal; bf16 at 2e-2 (the products run
    at other shapes and round h at other points)."""
    for cfg in (DBRX, KIMI):
        gen = torch.Generator(device="cuda").manual_seed(19)
        layer = moe.init_moe(cfg.d_model, cfg.d_ff, cfg.num_experts, generator=gen,
                             device="cuda")
        x = torch.randn(MOE_TOKENS, cfg.d_model, generator=gen, device="cuda").to(
            torch.bfloat16)
        k, e = cfg.top_k, cfg.num_experts
        layer.stats = {}
        y, _ = moe.moe_apply(layer, x, top_k=k, capacity_factor=e / k)
        if int(layer.stats["dropped"]):
            raise AssertionError(f"{cfg.name}: {int(layer.stats['dropped'])} dropped at "
                                 f"{e / k:g}")
        err_ref = check(f"{cfg.name} layer vs moe_reference", y,
                        moe.moe_reference(layer, x, top_k=k), torch.bfloat16)
        layer.stats = {}
        y, _ = moe.moe_apply(layer, x, top_k=k, capacity_factor=cfg.capacity_factor)
        want, dropped = moe_kept_plain(layer, x, k, cfg.capacity_factor)
        err_kept = check(f"{cfg.name} layer at {cfg.capacity_factor:g} vs the plain loop", y,
                         want, torch.bfloat16)
        if int(layer.stats["dropped"]) != dropped:
            raise AssertionError(f"{cfg.name}: dropped {int(layer.stats['dropped'])}, plain "
                                 f"{dropped}")
        first = int(layer.stats["first_top"])
        layer.stats = None
        ms = timed_ms(lambda: moe.moe_apply(layer, x, top_k=k,
                                            capacity_factor=cfg.capacity_factor))
        print(f"  (d) {cfg.name} layer ({e} experts of {cfg.d_model} -> {cfg.d_ff}, top "
              f"{k}), {MOE_TOKENS} tokens, bf16: at capacity {e / k:g} nothing dropped, max "
              f"abs err against moe_reference {err_ref:.3e}; at {cfg.capacity_factor:g} "
              f"{dropped} of {MOE_TOKENS * k} assignments dropped on both sides, max abs "
              f"err against the plain loop {err_kept:.3e} (tol {TOL[torch.bfloat16]}); "
              f"{first} of {MOE_TOKENS} tokens on the commonest first expert "
              f"({100 * first / MOE_TOKENS:.2f}%; 1 / E = {100 / e:.2f}%); moe_apply "
              f"{ms:.3f} ms")
        del layer, x, y, want
        free()


def moe_phase() -> dict[str, dict]:
    phase("19. the MoE family at full width (weights from a seeded generator, bf16, "
          "attn_impl='pallas'; each model freed before the next)")
    t0 = time.perf_counter()
    free()
    print(f"  live at the start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
    dbrx = moe_serve_phase(
        DBRX.replace(num_layers=DBRX_SERVE_LAYERS),
        f"a, a depth cut: {DBRX_SERVE_LAYERS} of 40 layers; 40 are 245 GiB", 2 << 30)
    kimi_cfg = KIMI.replace(num_layers=KIMI_SERVE_LAYERS)
    need = meta_bytes(kimi_cfg) + (1 << 30)
    spare = torch.cuda.mem_get_info()[0] - need
    print(f"  kimi-k2 at {KIMI_SERVE_LAYERS} layers reckoned {need / 2**30:.2f} GiB of weights "
          f"and pool, {spare / 2**30:.2f} GiB of the card left free")
    if spare < 4 << 30:
        raise AssertionError(f"kimi-k2 at {KIMI_SERVE_LAYERS} layers leaves under 4 GiB free")
    kimi = moe_serve_phase(
        kimi_cfg, f"b, a depth cut: {KIMI_SERVE_LAYERS} of 61 layers; 61 are 1.9 TiB", 1 << 30)
    train = moe_train_phase()
    moe_layer_phase()
    print(f"  phase 19: {time.perf_counter() - t0:.1f} s")
    return {"dbrx-132b serving": dbrx["counts"], "kimi-k2-1t-a32b serving": kimi["counts"],
            "dbrx-132b training": train["counts"]}


# ---------------------------------------------------------------------------
# phase 20: the MoE family, card against CPU
# ---------------------------------------------------------------------------


def moe_drops_card_vs_cpu(cfg, card, cpu, r) -> None:
    """The loss of one batch (B 4, S 64, 2 groups of 128 tokens) at capacity
    1.0 on both devices: within 1e-4, and every layer's dropped count above
    0 and equal."""
    tight = cfg.replace(capacity_factor=1.0)
    toks = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(4, 64)))
    res = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        stats = [{} for _ in model.blocks]
        for blk, st in zip(model.blocks, stats):
            blk.ffn.stats = st
        with torch.no_grad():
            loss, m = tf.loss_fn(tight, model, {"tokens": toks.to(dev),
                                                "targets": toks.to(dev)}, moe_groups=2)
        for blk in model.blocks:
            blk.ffn.stats = None
        res[dev] = (loss.item(), m["moe_aux"].item(), [int(st["dropped"]) for st in stats])
    (loss_c, aux_c, drop_c), (loss_h, aux_h, drop_h) = res["cuda"], res["cpu"]
    rel = max(abs(loss_c - loss_h) / abs(loss_h), abs(aux_c - aux_h) / abs(aux_h))
    if rel > 1e-4 or drop_c != drop_h or min(drop_c) == 0:
        raise AssertionError(f"{cfg.name} at capacity 1.0: card {res['cuda']}, CPU "
                             f"{res['cpu']}")
    print(f"  {cfg.name} at capacity factor 1.0 (B 4, S 64, 2 groups): loss and moe_aux "
          f"within {rel:.3e} relative (tol 1e-4); dropped per layer {drop_c} of "
          f"{4 * 64 * cfg.top_k} assignments on both")


def moe_gram_card_vs_cpu(cfg) -> None:
    """2 gram-tier steps (probes on the attention layers and the dense FFNs,
    the MoE FFNs in 2 groups) on the card and the CPU: losses and
    ``sq_norm_sum`` within 1e-4 relative, parameters within 1e-4, psgn
    launches on the card only."""
    seq = 64
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                        granule=2, lr=0.05, tick_every=4)
        engine = gram_engine(cfg, sgd(momentum=0.9), seq, 2, dev, moe_groups=2)
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, model, program, steps=2, seq_len=seq, micro_batch=2,
                             engine=engine, estimator="gram", log=lambda line: None)
        runs[dev] = (out["state"].div_state.sq_norm_sum.item(),
                     [x["loss"] for x in out["records"]], kernels.launch_counts())
    (sq_c, loss_c, counts_c), (sq_h, loss_h, counts_h) = runs["cuda"], runs["cpu"]
    rel = max([abs(sq_c - sq_h) / abs(sq_h)]
              + [abs(a - b) / abs(b) for a, b in zip(loss_c, loss_h)])
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    psgn_launches = sum(counts_c[k] for k in ("psgn_direct", "psgn_gram", "psgn_fused"))
    if rel > 1e-4 or err > 1e-4 or psgn_launches == 0 or any(counts_h.values()):
        raise AssertionError(f"{cfg.name} gram tier: sq_norm_sum {sq_c} / {sq_h}, losses "
                             f"{loss_c} / {loss_h}, parameters within {err:.3e}, launches "
                             f"{counts_c} / {counts_h}")
    print(f"  {cfg.name} gram tier, 2 steps: sq_norm_sum {sq_c:.6g}, losses and sq_norm_sum "
          f"within {rel:.3e} relative (tol 1e-4), parameters within {err:.3e} (tol 1e-4); "
          f"card launches {counts_c}")


def moe_card_vs_cpu_phase() -> None:
    phase("20. the reference's reduced MoE configs (hd 16, float32): card (kernels) "
          "against CPU (plain versions)")
    r = np.random.default_rng(20)
    for arch in ("dbrx-132b", "kimi-k2-1t-a32b"):
        cfg, card, cpu = reduced_serve_card_vs_cpu(arch, r)
        moe_drops_card_vs_cpu(cfg, card, cpu, r)
        print(f"  {arch} trains (moment tier, 2 groups):")
        lm_train_card_vs_cpu(cfg, moe_groups=2)
        moe_gram_card_vs_cpu(cfg)
        del card, cpu
    free()


# ---------------------------------------------------------------------------
# phase 21: the Mamba family at full width
# ---------------------------------------------------------------------------

FALCON = get_config("falcon-mamba-7b")
JAMBA = get_config("jamba-v0.1-52b")
# 21a's long prompt (tokens), 21b's cut and run, 21c's depth (one period)
FALCON_PROMPT = 8192
# 3 steps since phase 33 joined (4 before): the script keeps inside its limit
FALCON_TRAIN_LAYERS, FALCON_TRAIN_SEQ, FALCON_TRAIN_STEPS = 4, 4096, 3
JAMBA_SERVE_LAYERS = 8


def mamba_kernel_records(r) -> list[dict]:
    """Rows 1e and 4d: the chunk forward and paged decode at jamba's serving
    shapes (32/8 heads of hd 128, n_rep 4: its one attention layer a
    period), their launches counted on phase 21c's serving path."""
    path = {"paths": ["jamba-v0.1-52b serving"]}
    return [chunk_kernel_record(r, JAMBA, "jamba's serving shape", counter="chunk_attention",
                                name="chunk_attention (jamba: n_rep 4, serving)", **path),
            decode_kernel_record(r, JAMBA, "jamba's serving shape",
                                 counter="paged_decode_attention",
                                 name="paged_decode_attention (jamba: n_rep 4)", **path)]


def mamba_state_bytes(cfg) -> int:
    """One slot's decode state: per Mamba layer a float32 (d_inner, d_state)
    ``h`` and a (K-1, d_inner) conv tail in the compute type."""
    d_inner = cfg.ssm_expand * cfg.d_model
    layers = cfg.repeats * sum(kind == "mamba" for kind in cfg.pattern)
    return layers * (d_inner * cfg.ssm_state * 4 + (cfg.ssm_conv - 1) * d_inner * 2)


def scan_args(layer, x: torch.Tensor) -> list[torch.Tensor]:
    """The inputs of ``ssm.mamba_apply(layer, x)``'s chunk steps (no
    state): h0, dt, B, C and x after the convolution."""
    _, _, xi, dt, bmat, cmat = ssm._inputs(layer, x)
    d_inner, d_state = layer.A_log.shape
    h0 = torch.zeros((x.shape[0], d_inner, d_state), dtype=torch.float32, device=x.device)
    return [h0, dt, bmat, cmat, xi]


def falcon_requests(vocab: int, seed: int = 21) -> list[Request]:
    """5 greedy requests of 32 new tokens: one prompt of ``FALCON_PROMPT``
    tokens (32 chunks of 256), three of 64-700, and a repeat of the 700 one,
    last (a full-prompt hit replaying its cached Mamba states)."""
    r = np.random.default_rng(seed)
    reqs = [r.integers(1, vocab, size=n) for n in (FALCON_PROMPT, 64, 333, 700)]
    reqs.append(reqs[-1].copy())
    return [Request(prompt=p.astype(np.int32), max_new_tokens=32) for p in reqs]


def falcon_serve_phase() -> dict:
    """21a: falcon-mamba-7b at all 64 layers served through ``ServeEngine``
    (4 slots, max_seq 16384, block 16, prefill chunk 256) on
    ``falcon_requests``: no kernel launch (no attention; the pool holds
    nothing), every request finished, the full-prompt hit taken; decode
    step and chunk ms beside the HBM floor; one slot's state beside a dense
    KV cache of the long context; the scan's share of a chunk; the peak
    beside its reckoning."""
    cfg = FALCON
    state = mamba_state_bytes(cfg)
    w_bytes = meta_bytes(cfg)
    slots = 4
    # weights; the per-slot states, the prefill rows and the cached prompt
    # rows (5 requests); one chunk's scan (a_bar, bx, the scan's two
    # tensors and two temporaries, float32, at C 256)
    d_inner = cfg.ssm_expand * cfg.d_model
    transient = 6 * 256 * d_inner * cfg.ssm_state * 4
    reckon = (w_bytes + (slots + 2 * 5) * state + transient) / 2**30
    print(f"  (a) {cfg.name} at full depth, {cfg.num_layers} Mamba layers, d_model "
          f"{cfg.d_model}, d_inner {d_inner}, d_state {cfg.ssm_state}, dt_rank {cfg.dt_rank}, "
          f"no attention and no FFN, bf16; reckoned: weights {w_bytes / 2**30:.2f} GiB, a "
          f"slot's state {state / 1e6:.2f} MB, one chunk's scan {transient / 2**30:.2f} GiB; "
          f"{reckon:.2f} GiB in all")
    params, w_gib = init_timed(cfg)
    reqs = falcon_requests(cfg.vocab_size)
    out = serve_checked(cfg, params, reqs, max_slots=slots, max_seq=16384, block_size=16,
                        prompt_granule=16, prefill_chunk=256, prefix_sharing=True)
    st, counts = out["engine"].stats, out["counts"]
    if any(counts.values()) or st.shared_prefill_hits != 1:
        raise AssertionError(f"falcon-mamba: launches {counts} (expected none), "
                             f"{st.shared_prefill_hits} full-prompt hits (expected 1)")
    decode_ms, chunk_ms, n_dec, n_chunk = step_medians(out["steps"])
    floor_ms = 1e3 * weight_bytes(params) / PEAK_BYTES
    ctx = FALCON_PROMPT + 32
    dense_kv = 2 * cfg.num_layers * ctx * cfg.d_model * 2
    print(f"  launches {counts} (no attention); {st.prefill_chunks} chunks, {st.steps} "
          f"decode steps, {st.shared_prefill_hits} full-prompt hit")
    print(f"  decode step: median {decode_ms:.2f} ms over {n_dec} decode-only steps (buckets "
          f"{st.buckets}); every weight but the embedding {floor_ms:.2f} ms of HBM: the floor")
    print(f"  prefill chunk: median {chunk_ms:.2f} ms over {n_chunk} steps with chunks (decode "
          f"share subtracted); end to end {st.tokens} tokens in {out['wall']:.2f} s")
    print(f"  a slot's state: {state / 1e6:.2f} MB at any context; a dense MHA KV cache of "
          f"the same depth and width (k and v, bf16) over the long request's {ctx} tokens: "
          f"{dense_kv / 1e9:.2f} GB ({dense_kv / state:.0f}x)")
    # the scan's share of a chunk: one layer's mamba_apply at C 256 against
    # its chunk step alone (the rest: projections, the convolution, dt)
    layer = params.blocks[0].mamba
    x = torch.randn(1, 256, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(3),
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        args = scan_args(layer, x)
        layer_ms = timed_ms(lambda: ssm.mamba_apply(layer, x, chunk=256))
        scan_ms = timed_ms(lambda: ssm._scan(layer, *args, 256, False))
    print(f"  the scan at C 256: {scan_ms:.3f} ms of a layer's {layer_ms:.3f} ms "
          f"({100 * scan_ms / layer_ms:.1f}%); {cfg.num_layers} layers' scans "
          f"{cfg.num_layers * scan_ms:.1f} ms of the chunk's {chunk_ms:.1f} ms "
          f"({100 * cfg.num_layers * scan_ms / chunk_ms:.1f}%)")
    print(f"  memory reckoned {reckon:.2f} GiB (weights {w_gib:.2f}); measured peak "
          f"{out['peak']:.2f} GiB")
    del out, params, layer, args
    free()
    return {"counts": counts, "decode_ms": decode_ms, "chunk_ms": chunk_ms}


def falcon_train_phase() -> dict:
    """21b: falcon-mamba-7b widths at ``FALCON_TRAIN_LAYERS`` of 64 layers,
    S 4096, micro batch 2, remat (each layer and each scan chunk
    checkpointed), ``train_lm.train`` (``for_lm``, the moment tier), sgd
    with momentum 0.9, DiveBatch (m0 2, m_max 4, granule 2), ``FALCON_TRAIN_STEPS``
    steps: finite losses, no kernel launch; step ms, model FLOP/s (6 x the
    products' parameters x tokens), the scan's share of a step, the peak
    beside its reckoning."""
    cfg = FALCON.replace(num_layers=FALCON_TRAIN_LAYERS)
    s = FALCON_TRAIN_SEQ
    print(f"  (b) {cfg.name} widths at {cfg.num_layers} of 64 layers, S {s}, bf16, remat, "
          f"micro batch 2, for_lm on the moment tier:")
    params, _ = init_timed(cfg)
    n = sum(p.numel() for p in params.parameters())
    largest = max(p.numel() for p in params.parameters())
    # the products a token runs: the four projections a layer, the head
    n_prod = sum(p.numel() for name, p in params.named_parameters()
                 if name.endswith("proj.weight") or name == "lm_head.weight")
    d_inner = cfg.ssm_expand * cfg.d_model
    scan_level = 2 * 256 * d_inner * cfg.ssm_state * 4  # one (B, C, d_inner, d_state) f32
    # weights, gradients and momenta in bf16, grad_sum and the microbatch
    # accumulator in float32 (14 B); sgd's float32 copy of the largest
    # tensor (8 B); one chunk's recomputed scan under backward: 2 tensors
    # a level over log2(256) levels plus a_bar and bx; the recomputed
    # layer's sequence-long tensors and their gradients, about 40 bytes a
    # (token, channel): in_proj's output, the convolution and its silu in
    # bf16, dt and y in float32, twice
    layer_acts = 40 * 2 * s * d_inner
    reckon = (14 * n + 8 * largest + (2 * 8 + 2) * scan_level + layer_acts) / 2**30
    program = train_lm.make_program("divebatch", m0=2, m_max=4, delta=0.5, granule=2,
                                    lr=0.02, tick_every=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=FALCON_TRAIN_STEPS, seq_len=s,
                         micro_batch=2, attn_impl="pallas", log=lambda line: None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = kernels.launch_counts()
    recs = out["records"]
    for rec in recs:
        tick = (f"; tick: Delta {rec['diversity']:.6f}, batch {rec['batch']} -> "
                f"{rec['next_batch']}" if "diversity" in rec else "")
        print(f"    step {rec['step']}: batch {rec['batch']} ({rec['num_micro']} "
              f"microbatches), ce_loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms{tick}")
    if not all(np.isfinite([rec["loss"] for rec in recs])) or any(counts.values()):
        raise AssertionError(f"falcon-mamba training: records {recs}, launches {counts}")
    steady = recs[1:]
    secs = [x["seconds"] for x in steady]
    flops = 6 * n_prod * s * sum(x["batch"] for x in steady)
    step_ms = {m: 1e3 * statistics.median([x["seconds"] for x in steady if x["batch"] == m])
               for m in sorted({x["batch"] for x in steady})}
    print(f"  launches {counts} (no attention); step ms by batch (median, steps "
          f"2-{FALCON_TRAIN_STEPS}) " + ", ".join(f"{m}: {v:.1f}" for m, v in step_ms.items())
          + f"; {sum(x['batch'] * s for x in steady) / sum(secs):.1f} tokens/s; "
          f"{6 * n_prod * s:.4e} model FLOP a sequence (6 x {n_prod / 1e9:.3f} B parameters "
          f"in products x S); {flops / sum(secs) / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / sum(secs) / PEAK_BF16:.1f}% of 989")
    # the scan's share of a step: one layer's forward and backward at batch
    # 2, S 4096 under remat, against its chunk steps alone
    layer = params.blocks[0].mamba
    x = torch.randn(2, s, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda").to(torch.bfloat16).requires_grad_(True)

    def layer_fb():
        ssm.mamba_apply(layer, x, chunk=cfg.ssm_chunk, remat=True).float().sum().backward()

    with torch.no_grad():
        leaves = [t.detach().requires_grad_(True) for t in scan_args(layer, x)]

    def scan_fb():
        for t in leaves:
            t.grad = None
        ssm._scan(layer, *leaves, cfg.ssm_chunk, True)[1].float().sum().backward()

    layer_ms = timed_ms(layer_fb, iters=3)
    scan_ms = timed_ms(scan_fb, iters=3)
    params.zero_grad(set_to_none=True)
    b2 = step_ms.get(2, next(iter(step_ms.values())))
    print(f"  the scan, forward and backward at B 2, S {s} under remat: {scan_ms:.1f} ms of "
          f"a layer's {layer_ms:.1f} ms ({100 * scan_ms / layer_ms:.1f}%; its inputs' "
          f"projections included in the layer only); {cfg.num_layers} layers' scans "
          f"{cfg.num_layers * scan_ms:.1f} ms of a batch-2 step's {b2:.1f} ms "
          f"({100 * cfg.num_layers * scan_ms / b2:.1f}%)")
    print(f"  memory reckoned: 14 B x {n / 1e9:.3f} B parameters + 8 B x {largest / 1e9:.3f} B "
          f"+ one chunk's scan under backward {(2 * 8 + 2) * scan_level / 2**30:.2f} GiB + "
          f"the recomputed layer's activations {layer_acts / 2**30:.2f} GiB = "
          f"{reckon:.2f} GiB; measured peak {peak:.2f} GiB")
    del out, params, layer, x, leaves
    free()
    return {"counts": counts, "step_ms": step_ms, "peak": peak}


def jamba_serve_phase() -> dict:
    """21c: jamba-v0.1-52b at ``JAMBA_SERVE_LAYERS`` layers (one period:
    7 Mamba layers, attention at position 4, MoE FFNs at the odd positions)
    served on phase 4's trace and engine settings: one chunk launch per
    prefill chunk and one paged decode launch per decode step (its one
    attention layer), decode step and chunk ms, each MoE layer's drop share
    in prefill and decode, the peak beside its reckoning."""
    cfg = JAMBA.replace(num_layers=JAMBA_SERVE_LAYERS, attn_impl="pallas")
    w_bytes = meta_bytes(cfg)
    print(f"  (c) {cfg.name}, a depth cut: {cfg.num_layers} of 32 layers (one period; 32 are "
          f"{4 * w_bytes / 2**30:.0f} GiB), d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of hd {cfg.resolved_head_dim} (n_rep "
          f"{cfg.num_heads // cfg.num_kv_heads}) at position 4, {cfg.num_experts} experts of "
          f"d_ff {cfg.d_ff}, top {cfg.top_k}, capacity factor {cfg.capacity_factor:g}, bf16; "
          f"weights reckoned {w_bytes / 2**30:.2f} GiB:")
    params, w_gib = init_timed(cfg)
    reqs = slice_requests(cfg.vocab_size)
    with moe_drop_tally(params) as tally:
        out = serve_checked(cfg, params, reqs, max_slots=8, max_seq=2048, block_size=16,
                            prompt_granule=16, prefill_chunk=256, prefix_sharing=True)
        shares = {k: moe_shares(v, cfg.top_k) for k, v in tally.items()}
    n_attn = cfg.repeats * len(tf.paged_positions(cfg))
    times = serve_report(out, cfg, reqs, per_chunk=n_attn, per_step=n_attn)
    for kind, (dropped, first) in shares.items():
        print(f"  capacity drops in {kind} (factor {cfg.capacity_factor:g}), per MoE layer: "
              + ", ".join(f"{100 * x:.2f}%" for x in dropped))
        print(f"  tokens on their group's commonest first expert in {kind}, per MoE layer: "
              + ", ".join(f"{100 * x:.2f}%" for x in first)
              + f" (1 / E = {100 / cfg.num_experts:.2f}%)")
    floor_ms = 1e3 * weight_bytes(params) / PEAK_BYTES
    print(f"  every weight but the embedding (the capacity form reads every expert) "
          f"{floor_ms:.2f} ms of HBM: the decode step's floor, beside its median "
          f"{times['decode_ms']:.2f} ms")
    slots_state = 8 * mamba_state_bytes(cfg) / 2**30
    reckon = w_gib + pool_gib(out["engine"]) + slots_state
    print(f"  memory reckoned: weights {w_gib:.2f} + pool {pool_gib(out['engine']):.2f} + 8 "
          f"slots' Mamba states {slots_state:.3f} = {reckon:.2f} GiB; measured peak "
          f"{out['peak']:.2f} GiB")
    counts = out["counts"]
    del out, params
    free()
    return {"counts": counts, "floor_ms": floor_ms, **times}


def mamba_phase() -> dict[str, dict]:
    phase("21. the Mamba family at full width (weights from a seeded generator, bf16, "
          "attn_impl='pallas'; each model freed before the next)")
    t0 = time.perf_counter()
    free()
    falcon = falcon_serve_phase()
    train = falcon_train_phase()
    jamba = jamba_serve_phase()
    print(f"  phase 21: {time.perf_counter() - t0:.1f} s")
    return {"falcon-mamba-7b serving": falcon["counts"],
            "falcon-mamba-7b training": train["counts"],
            "jamba-v0.1-52b serving": jamba["counts"]}


# ---------------------------------------------------------------------------
# phase 22: the Mamba family, card against CPU
# ---------------------------------------------------------------------------


def mamba_card_vs_cpu_phase() -> None:
    phase("22. the reference's reduced Mamba configs (float32): card (kernels) against "
          "CPU (plain versions)")
    r = np.random.default_rng(22)
    for arch in ("falcon-mamba-7b", "jamba-v0.1-52b"):
        cfg, card, cpu = reduced_serve_card_vs_cpu(arch, r)
        del card, cpu
        groups = 2 if cfg.num_experts else 1
        # reduced jamba at lr 0.05 turns a 1e-7 relative change of its weights
        # into 1e-3 of its parameters in 6 steps, on the CPU alone
        # (tools/train_drift.py); at lr 0.01 into 6e-6, so 1e-4 still tells a
        # fault from rounding
        lr = 0.01 if cfg.num_experts else 0.05
        print(f"  {arch} trains (moment tier, lr {lr}"
              f"{', 2 groups' if cfg.num_experts else ''}):")
        lm_train_card_vs_cpu(cfg, moe_groups=groups, lr=lr)
        if cfg.num_experts:
            moe_gram_card_vs_cpu(cfg)
    free()


# ---------------------------------------------------------------------------
# phase 23: the exact tier at full width
# ---------------------------------------------------------------------------

# the exact tier's vmap path (``make_train_step(estimator="exact",
# psn_impl="vmap")``): per-sample gradients EXACT_CHUNK samples at a time,
# EXACT_STEPS steps at batch 4 (2 microbatches of 2); hubert-xlarge at a
# depth cut (phase 14c's)
EXACT_STEPS, EXACT_CHUNK = 4, 2
EXACT_ENCODER_LAYERS, EXACT_ENCODER_STEPS = 12, 2
# the vmapped norms (bf16 gradients of 2 samples at once, no remat) against
# a loop over the samples (remat): the same kernels, cuBLAS at other shapes;
# an H100 run (NVIDIA H100 80GB HBM3, 700 W) put a sample 9.5e-5 apart
EXACT_LOOP_TOL = 1e-3


def example_loss(cfg):
    """The per-sample LM loss both packages' tests use: one sequence as a
    batch of one."""
    return lambda p, e: tf.loss_fn(cfg, p, {k: v[None] for k, v in e.items()})[0]


def exact_engine(cfg, optimizer, micro_batch: int) -> StepEngine:
    """The hand-built exact-tier engine on the LM loss: ``vmap(grad(
    example_loss))`` over ``EXACT_CHUNK`` samples at a time."""

    def build(num_micro: int, tier: str):
        return make_train_step(cfg, optimizer, num_micro, estimator=tier,
                               example_loss=example_loss(cfg), psn_impl="vmap",
                               psn_chunk=EXACT_CHUNK)

    engine = StepEngine(build, lm_bucket_of(micro_batch))
    engine.tier = "exact"
    return engine


def exact_run(cfg, params, *, seq: int, steps: int, batches=None) -> tuple[dict, list, float]:
    """``steps`` exact-tier steps at batch 4 (a tick every 2 steps) through
    ``train_lm.train``: finite losses; launches exactly the main pass's 2L
    forward, L dq and L dk/dv per microbatch plus one of each per layer for
    each fold of ``EXACT_CHUNK`` samples, all on the planned routes.
    Returns (the launch counts, the records, the peak GiB)."""
    engine = exact_engine(cfg, sgd(momentum=0.9), TRAIN_MICRO)
    program = train_lm.make_program("divebatch", m0=4, m_max=4, delta=0.5,
                                    granule=TRAIN_MICRO, lr=TRAIN_LR, tick_every=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=steps, seq_len=seq,
                         micro_batch=TRAIN_MICRO, engine=engine, estimator="exact",
                         batches=batches, log=lambda line: None)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = out["records"]
    for rec in recs:
        tick = (f"; tick: Delta {rec['diversity']:.6f}, gns {rec['gns']:.6g}"
                if "diversity" in rec else "")
        print(f"    step {rec['step']}: batch {rec['batch']} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms{tick}")
    if not all(np.isfinite([rec["loss"] for rec in recs] + [rec["diversity"] for rec in recs
                                                            if "diversity" in rec])):
        raise AssertionError(f"exact tier: non-finite loss or Delta: {recs}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers, folds = cfg.num_layers, -(-TRAIN_MICRO // EXACT_CHUNK)
    per_mb = {"chunk_attention": (2 + folds) * layers, "flash_dq": (1 + folds) * layers,
              "flash_dkv": (1 + folds) * layers}
    want = {**{k: v * n_micro for k, v in per_mb.items()}, "paged_decode_attention": 0,
            **NO_PSGN}
    if counts != want:
        raise AssertionError(f"exact-tier launches {counts}, expected {want}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="exact-tier training")
    print(f"  launches: {counts} (= main pass {2 * layers}, {layers}, {layers} + "
          f"{folds} fold of {EXACT_CHUNK} samples x {layers}, {layers}, {layers} = "
          f"{per_mb['chunk_attention']}, {per_mb['flash_dq']}, {per_mb['flash_dkv']} x "
          f"{n_micro} microbatches; one launch per layer for the fold, not one per sample); "
          f"attention routes {attention_routes()}")
    del out, engine
    return counts, recs, peak


def step_ms_by_batch(recs) -> dict[int, float]:
    """Median step ms by batch, the first step excluded."""
    steady = recs[1:]
    return {m: 1e3 * statistics.median([x["seconds"] for x in steady if x["batch"] == m])
            for m in sorted({x["batch"] for x in steady})}


def exact_phase() -> tuple[dict, dict]:
    """Returns the launch counts of the two exact-tier paths (Yi-6B's and
    hubert-xlarge's)."""
    phase(f"23. the exact tier at full width: Yi-6B widths, {TRAIN_LAYERS} of 32 layers, "
          f"bf16, remat, attn_impl='pallas', per-sample gradients by torch.func.vmap "
          f"(psn_impl='vmap', psn_chunk {EXACT_CHUNK})")
    free()
    t0 = time.perf_counter()
    cfg = YI.replace(num_layers=TRAIN_LAYERS, attn_impl="pallas")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n = sum(p.numel() for p in params.parameters())
    largest = max(p.numel() for p in params.parameters())
    d, f, s = cfg.d_model, cfg.d_ff, TRAIN_SEQ
    # the reckoning of the per-sample pass's peak: the state it runs beside
    # (bf16 weights and momenta, the float32 microbatch accumulator and
    # grad_sum: 12 B a parameter); EXACT_CHUNK per-sample gradient trees in
    # bf16; the float32 cast and square of the largest leaf for each
    # sample; the LM head's float32 dW for each sample in the loss's
    # backward; the activations without remat, about 20 d + 10 f bytes a
    # token a layer (the norms' inputs and float32 copies, q, k, v and the
    # attention's output, the FFN's input, gate, up, sigmoid and product)
    terms = {"state 12 B x N": 12 * n, "per-sample trees": 2 * EXACT_CHUNK * n,
             "largest leaf cast": 2 * 4 * EXACT_CHUNK * largest,
             "head dW": 4 * EXACT_CHUNK * cfg.vocab_size * d,
             "activations": (20 * d + 10 * f) * EXACT_CHUNK * s * cfg.num_layers}
    reckon = sum(terms.values()) / 2**30
    print(f"  (a) {n / 1e9:.3f} B parameters, S {s}, micro batch {TRAIN_MICRO}, sgd "
          f"(momentum 0.9, lr {TRAIN_LR}), {EXACT_STEPS} steps at batch 4; reckoned peak: "
          + " + ".join(f"{k} {v / 2**30:.2f}" for k, v in terms.items())
          + f" = {reckon:.2f} GiB (psn_chunk {EXACT_CHUNK} fits 80 GiB)")
    counts, recs, peak = exact_run(cfg, params, seq=s, steps=EXACT_STEPS)
    TIER_MS["exact"] = step_ms_by_batch(recs)
    print("  step ms at batch 4 (median, steps 2-" f"{EXACT_STEPS}): exact "
          f"{TIER_MS['exact'][4]:.1f}; phase 6's moment tier {TIER_MS['moment'][4]:.1f}, "
          f"phase 8's gram tier {TIER_MS['gram'][4]:.1f} "
          f"({TIER_MS['exact'][4] / TIER_MS['moment'][4]:.2f}x the moment tier)")
    print(f"  peak device memory {peak:.2f} GiB; reckoned {reckon:.2f} GiB")

    # one microbatch: the main pass and the per-sample pass timed apart
    mb = {k: torch.from_numpy(v).to("cuda")
          for k, v in TokenStream(cfg.vocab_size, seed=1).batch(0, TRAIN_MICRO, s).items()}
    state_params = list(params.parameters())
    ex = example_loss(cfg)
    split = {}
    for _ in range(2):  # the second round is the one kept
        _, split["main pass"] = timed_s(lambda: torch.autograd.grad(
            tf.loss_fn(cfg, params, mb)[0], state_params))
        norms, split["per-sample pass"] = timed_s(
            lambda: diversity.persample_sq_norms(ex, params, mb))
    share = split["per-sample pass"] / sum(split.values())
    print("  one exact-tier microbatch: " + ", ".join(
        f"{k} {1e3 * v:.1f} ms" for k, v in split.items())
        + f"; the per-sample pass {100 * share:.1f}% of it")
    pass_peak = peak_gib(lambda: diversity.persample_sq_norms(ex, params, mb))
    print(f"  the per-sample pass's peak above the resident "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB: {pass_peak:.2f} GiB")

    # the same microbatch's norms by a loop over its samples: plain autograd
    # (remat on), one sample at a time through the same kernels
    loop = []
    for i in range(TRAIN_MICRO):
        grads = torch.autograd.grad(ex(params, {k: v[i] for k, v in mb.items()}),
                                    state_params)
        loop.append(sum(g.float().square().sum() for g in grads))
        del grads
    loop = torch.stack(loop)
    rel = ((norms.sum() - loop.sum()).abs() / loop.sum()).item()
    each = ((norms - loop).abs() / loop).max().item()
    if not torch.isfinite(norms).all() or rel > EXACT_LOOP_TOL or each > EXACT_LOOP_TOL:
        raise AssertionError(f"vmap norms {norms.tolist()} against the loop's {loop.tolist()}")
    print(f"  sq_norm_sum of the microbatch by vmap {norms.sum().item():.6g} (per sample "
          f"{[round(x, 4) for x in norms.tolist()]}), by a loop of torch.autograd.grad "
          f"{loop.sum().item():.6g}: within {rel:.3e} relative, each sample within "
          f"{each:.3e} (tol {EXACT_LOOP_TOL})")
    # the probe path's estimate (psn_impl="kernel"): the probed dense
    # layers' per-sample norms, bias terms included; not checked
    hook = lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b)  # noqa: E731
    specs = probes.probe_specs(cfg, TRAIN_MICRO, s, device="cuda")
    _, acts, pgrads = probes.probe_grads(hook, params, specs, mb)
    probe = ops.persample_sq_norm_tree(acts, pgrads, scale=float(TRAIN_MICRO), bias=True)
    print(f"  the probe path's estimate (psn_impl='kernel') of the same microbatch "
          f"{probe.sum().item():.6g}: {100 * probe.sum().item() / norms.sum().item():.2f}% "
          f"of the exact norm (per sample "
          f"{[f'{100 * a / b:.2f}%' for a, b in zip(probe.tolist(), norms.tolist())]}; "
          f"probes cover {100 * probes.coverage(cfg):.2f}% of the parameters)")
    del params, state_params, acts, pgrads, norms, loop
    free()

    enc = HUBERT.replace(num_layers=EXACT_ENCODER_LAYERS, attn_impl="pallas")
    print(f"  (b) hubert-xlarge widths at {enc.num_layers} of {HUBERT.num_layers} layers "
          f"(non-causal, hd {enc.resolved_head_dim}), S {HUBERT_SEQ}, {EXACT_ENCODER_STEPS} "
          f"steps at batch 4:")
    params = tf.init_params(enc, torch.Generator(device="cuda").manual_seed(1), "cuda")
    enc_counts, recs, peak = exact_run(enc, params, seq=HUBERT_SEQ, steps=EXACT_ENCODER_STEPS,
                                       batches=train_lm.frame_batches(enc, 7))
    print(f"  step ms at batch 4 (the second step): {1e3 * recs[-1]['seconds']:.1f}; peak "
          f"device memory {peak:.2f} GiB")
    del params
    free()
    print(f"  phase 23: {time.perf_counter() - t0:.1f} s")
    return counts, enc_counts


# ---------------------------------------------------------------------------
# phase 24: the exact tier on the reduced configs, card against CPU
# ---------------------------------------------------------------------------

# every architecture's reduced config with the lane it runs here: the
# kernel lane where it has attention to take it, the flash lane (plain
# PyTorch, 8-token blocks) and the dense lane at least once each
EXACT_LANES = {
    "yi-6b": dict(attn_impl="pallas"), "qwen2-7b": dict(attn_impl="pallas"),
    "llama3-405b": dict(attn_impl="dense"),
    "gemma2-27b": dict(attn_impl="flash", flash_q_block=8, flash_kv_block=8),
    "internvl2-1b": dict(attn_impl="pallas"), "dbrx-132b": dict(attn_impl="pallas"),
    "kimi-k2-1t-a32b": dict(attn_impl="flash", flash_q_block=8, flash_kv_block=8),
    "falcon-mamba-7b": {}, "jamba-v0.1-52b": dict(attn_impl="pallas"),
    "hubert-xlarge": dict(attn_impl="pallas")}
EXACT_CPU_TOL = 1e-4


def exact_batch(cfg, r, n: int = 3, seq: int = 32) -> dict:
    """``n`` sequences: tokens or frame embeddings, and their targets."""
    if cfg.input_mode == "tokens":
        toks = r.integers(1, cfg.vocab_size, size=(n, seq + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return {"embeddings": r.standard_normal((n, seq, cfg.d_model)).astype(np.float32),
            "targets": r.integers(0, cfg.vocab_size, size=(n, seq)).astype(np.int32)}


def exact_card_vs_cpu_phase() -> None:
    phase("24. the reference's reduced configs (float32, remat on): the exact tier's "
          "per-sample norms by vmap on the card (kernels) against the CPU (plain versions)")
    r = np.random.default_rng(24)
    for arch, lane in EXACT_LANES.items():
        cfg = get_config(arch, reduced=True).replace(remat=True, **lane)
        cpu = tf.init_params(cfg, torch.Generator().manual_seed(24), "cpu")
        card = tf.build(cfg, "cuda")
        card.load_state_dict(cpu.state_dict())
        b = exact_batch(cfg, r)
        kernels.reset_launch_counts()
        got = diversity.persample_sq_norms(example_loss(cfg), card,
                                           {k: torch.from_numpy(v).cuda() for k, v in b.items()})
        torch.cuda.synchronize()
        counts, routes = kernels.launch_counts(), kernels.route_counts()
        want = diversity.persample_sq_norms(example_loss(cfg), cpu,
                                            {k: torch.from_numpy(v) for k, v in b.items()})
        gap = ((got.cpu() - want).abs() / want.abs()).max().item()
        if not torch.isfinite(want).all() or gap > EXACT_CPU_TOL:
            raise AssertionError(f"{arch}: card {got.tolist()} against the CPU "
                                 f"{want.tolist()}")
        # the kernel lane: one forward, dq and dk/dv per attention layer for
        # the fold of 3 samples, on the FMA kernels (float32, hd 16)
        n_attn = sum(kind != "mamba" for kind in
                     (cfg.pattern[i % cfg.period] for i in range(cfg.num_layers)))
        per = n_attn if cfg.attn_impl == "pallas" else 0
        expect = {**{k: 0 for k in counts}, "chunk_attention": per, "flash_dq": per,
                  "flash_dkv": per}
        if counts != expect:
            raise AssertionError(f"{arch}: launches {counts}, expected {expect}")
        if per:
            attn_routes(counts, plan_of(cfg, torch.float32), what=f"{arch} exact tier",
                        routes=routes)
        lane = cfg.attn_impl if n_attn else "no attention"
        why = (f"1 x {n_attn} attention layers for the fold of 3" if per
               else "the lane runs no kernel")
        print(f"  {arch} [{lane}]: card {[round(x, 4) for x in got.tolist()]}, max rel gap "
              f"{gap:.3e} (tol {EXACT_CPU_TOL}); launches {per}, {per}, {per} ({why})")
    free()


# ---------------------------------------------------------------------------
# phases 25-26: the training state sharded over ranks
# ---------------------------------------------------------------------------

SHARD_LAYERS, SHARD_SEQ, SHARD_MICRO, SHARD_STEPS, SHARD_WORLD = 4, 2048, 2, 3, 2
# the sharded bf16 run against the whole one: the ranks take one sequence of
# each microbatch (cuBLAS at other shapes) and sum their bf16 gradient
# shards; losses relative, parameters absolute (a bf16 flip of a 0.02
# weight is 6e-5)
SHARD_LOSS_RTOL, SHARD_PARAM_ATOL = 1e-3, 1e-3
DBRX_EP_SEQ, DBRX_EP_FACTOR = 256, 8.0
DBRX_PICKED = ("blocks.0.ffn.w_up", "blocks.0.attn.q.weight", "embed.weight")
SHARD_REDUCED = ("yi-6b", "dbrx-132b", "falcon-mamba-7b", "hubert-xlarge")
SHARD_CPU_TOL = 1e-4  # phase 7's bound: the card's kernels against the CPU's plain versions
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
               "all_reduce")


def shard_plan_abstract(world: int):
    """A rung's roles (``fsdp = ep = data``, no tp) on an abstract mesh: the
    plan the reckoning reads."""
    from repro_torch.dist.plan import ShardingPlan, abstract_mesh

    return ShardingPlan(mesh=abstract_mesh((world,), ("data",)), dp=("data",),
                        fsdp=("data",), tp=None, ep=("data",))


def reckoned_state_bytes(cfg, world: int, plan=None) -> tuple[int, int, int]:
    """``(per rank, whole, per-rank parameters)``: the bytes of the
    parameters, the sgd momenta (the parameters' type) and ``grad_sum``
    (float32), from ``infer_pspecs`` on the reference's paths and stacked
    shapes (``interop.layout`` of a meta model), on ``plan`` (default a
    ``(data world)`` rung)."""
    from repro_torch import interop
    from repro_torch.dist import sharding

    plan = plan or shard_plan_abstract(world)
    model = tf.build(cfg, "meta")
    named = dict(model.named_parameters())
    tree, size = {}, {}
    for leaf in interop.layout(model):
        p = named[leaf.names[0]]
        perm = sharding._FORM_PERM.get(leaf.form, tuple(range(p.dim())))
        ref = tuple(p.shape[j] for j in perm)
        tree[leaf.path] = ((len(leaf.names),) + ref) if leaf.stacked else ref
        size[leaf.path] = 2 * p.element_size() + 4
    specs = sharding.infer_pspecs(tree, plan)
    mine = sum(math.prod(sharding.local_shape(sh, specs[k], plan)) * size[k]
               for k, sh in tree.items())
    whole = sum(math.prod(sh) * size[k] for k, sh in tree.items())
    params = sum(math.prod(sharding.local_shape(sh, specs[k], plan)) for k, sh in tree.items())
    return mine, whole, params


def state_bytes(state) -> int:
    """Resident bytes of a state's parameter-shaped leaves, leaf by leaf:
    the parameters, the momenta, ``grad_sum``."""
    leaves = (list(state.params.parameters()) + list(state.opt_state.momentum)
              + list(state.div_state.grad_sum.values()))
    return sum(t.numel() * t.element_size() for t in leaves)


def clock_delta(before: dict, after: dict) -> dict:
    return {k: {n: after[k][n] - before[k][n] for n in COLLECTIVES} for k in after}


def whole_params(model, names=None) -> dict:
    """A model's parameters (those of ``names``, or all) whole, gathered
    when sharded (a collective over the rung), by name."""
    from repro_torch.dist import sharding

    layout = sharding.layout_of(model)
    return {n: p.detach() if layout is None else layout.unshard(n, p.detach())
            for n, p in model.named_parameters() if names is None or n in names}


def shard_yi_cfg():
    return YI.replace(num_layers=SHARD_LAYERS, attn_impl="pallas")


def shard_yi_program():
    """The tick-fired DiveBatch program of 25a: batch 2 (one microbatch, a
    sequence per rank), a tick every 2 steps that may grow it to 4."""
    return train_lm.make_program("divebatch", m0=SHARD_MICRO, m_max=2 * SHARD_MICRO,
                                 delta=0.5, granule=SHARD_MICRO, lr=TRAIN_LR, tick_every=2)


def shard_yi_whole(path: str, dev: str = "cuda") -> dict:
    """25a's run with whole state on one process (in the parent): losses,
    batches, buckets; its final parameters to ``path``."""
    cfg = shard_yi_cfg()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=SHARD_MICRO,
                               attn_impl="pallas", dp_size=SHARD_WORLD)
    torch.cuda.reset_peak_memory_stats()
    out = train_lm.train(cfg, params, shard_yi_program(), steps=SHARD_STEPS,
                         seq_len=SHARD_SEQ, micro_batch=SHARD_MICRO, engine=engine,
                         log=lambda line: None)
    torch.save({n: p.detach().cpu() for n, p in params.named_parameters()}, path)
    rec = {"loss": [r["loss"] for r in out["records"]],
           "batch": [r["batch"] for r in out["records"]],
           "buckets": list(engine.stats.buckets),
           "bytes": state_bytes(out["state"]),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "ms": [1e3 * r["seconds"] for r in out["records"]]}
    del out, params, engine
    free()
    return rec


def rank_shard_yi(dev, plan, whole_path: str) -> dict:
    """25a on a rank: Yi-6B sharded over the rung, the moment tier under the
    program, collectives by kind per step; then one gram-tier step."""
    cfg = shard_yi_cfg()
    opt = sgd(momentum=0.9)
    params = place(tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), plan)
    engine = StepEngine.for_lm(cfg, opt, micro_batch=SHARD_MICRO, attn_impl="pallas",
                               dp_size=SHARD_WORLD, plan=plan)
    clock = CollectiveClock()
    steps, inner = [], engine.step

    def step(state, batch, lr):
        before = clock.snapshot()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = inner(state, batch, lr)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        steps.append({"batch": int(next(iter(batch.values())).shape[0]), "loss": loss,
                      "ms": 1e3 * (time.perf_counter() - t1),
                      "coll": clock_delta(before, clock.snapshot())})
        return state, metrics

    engine.step = step
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        out = train_lm.train(cfg, params, shard_yi_program(), steps=SHARD_STEPS,
                             seq_len=SHARD_SEQ, micro_batch=SHARD_MICRO, engine=engine,
                             plan=plan, log=lambda line: None)
        torch.cuda.synchronize()
        counts, routes = kernels.launch_counts(), kernels.route_counts()
        state = out["state"]
        rec = {"steps": steps, "num_micro": [r["num_micro"] for r in out["records"]],
               "buckets": list(engine.stats.buckets), "launches": counts, "routes": routes,
               "bytes": state_bytes(state),
               "params": sum(p.numel() for p in state.params.parameters()),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "plan": plan_of(cfg, torch.bfloat16)}
        # the gathered parameters against the whole run's (rank 0 reads them)
        whole = torch.load(whole_path) if dist.get_rank() == 0 else None
        gap = 0.0
        for n, w in whole_params(state.params).items():
            if whole is not None:
                gap = max(gap, (w.float().cpu() - whole[n].float()).abs().max().item())
        rec["param_gap"] = gap
        del whole
        # one gram-tier step from this state: its probe pass on the gathered blocks
        gram = make_train_step(
            cfg, opt, 1, plan=plan, estimator="gram",
            probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
            probe_specs=lambda p, n: probes.probe_specs(cfg, n, SHARD_SEQ, device=dev))
        batch = TokenStream(cfg.vocab_size, seed=5).batch(0, SHARD_MICRO, SHARD_SEQ)
        kernels.reset_launch_counts()
        before = clock.snapshot()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = gram(state, batch, TRAIN_LR)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        rec["gram"] = {"ms": 1e3 * (time.perf_counter() - t1), "loss": loss,
                       "sq_norm_sum": state.div_state.sq_norm_sum.item(),
                       "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
                       "coll": clock_delta(before, clock.snapshot())}
    finally:
        clock.close()
    del out, state, params, engine
    return rec


def dbrx_ep_cfg(factor: float = DBRX_EP_FACTOR, ep: bool = True):
    return DBRX.replace(num_layers=1, attn_impl="pallas", capacity_factor=factor,
                        **({"moe_impl": "ep"} if ep else {}))


def dbrx_ep_batch():
    return TokenStream(DBRX.vocab_size, seed=2).batch(0, SHARD_WORLD, DBRX_EP_SEQ)


def dbrx_one_process(dev: str = "cuda") -> dict:
    """25c's reference in the parent: dbrx-132b at 1 layer on one process
    through ``moe_apply`` (2 routing groups: one per rank's sequence), two
    plain sgd steps at capacity 8.0 (no momentum, no diversity tier: the
    ranks' state of two such models shares the card)."""
    cfg = dbrx_ep_cfg(ep=False)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # plain sgd, no diversity tier: two ranks' dbrx state share the one card
    opt = sgd()
    state = init_state(params, opt)
    step = make_train_step(cfg, opt, 1, dp_size=SHARD_WORLD, moe_groups=SHARD_WORLD,
                           diversity_on=False)
    losses = []
    for _ in range(2):
        state, metrics = step(state, dbrx_ep_batch(), TRAIN_LR)
        losses.append(float(metrics["loss"]))
    w = {n: params.get_parameter(n).detach().float().cpu() for n in DBRX_PICKED}
    del state, params
    free()
    return {"loss": losses, "w": w}


def rank_dbrx_ep(dev, plan) -> dict:
    """25c on a rank: dbrx-132b at 1 layer, ``moe_impl="ep"``, its 8 of 16
    experts resident; two plain sgd steps at capacity 8.0 (nothing drops),
    then a forward at the config's own capacity counting the drops.  Each
    rank holds its parameters, ``grad_sum`` (bf16: the diversity tier is
    off) and the step's float32 accumulator: ≈ 26 GB a rank, two ranks on
    the card."""
    from repro_torch.dist.plan import use_plan

    cfg = dbrx_ep_cfg()
    opt = sgd()
    params = place(tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), plan)
    layer = params.blocks[0].ffn
    expert_bytes = sum(w.numel() * w.element_size() for w in (layer.w_gate, layer.w_up,
                                                               layer.w_out))
    state = init_state(params, opt, div_dtype=torch.bfloat16)  # grad_sum unread here
    step = make_train_step(cfg, opt, 1, plan=plan, diversity_on=False)
    clock = CollectiveClock()
    kernels.reset_launch_counts()
    losses, ms = [], []
    try:
        before = clock.snapshot()
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step(state, dbrx_ep_batch(), TRAIN_LR)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
        coll = clock_delta(before, clock.snapshot())
        counts = kernels.launch_counts()
        picked = {n: w.float().cpu() for n, w in whole_params(params, DBRX_PICKED).items()}
        # the config's own capacity: what drops on this rank's tokens
        own = dbrx_ep_cfg(DBRX.capacity_factor)
        layer.stats = {}
        mine = {k: torch.as_tensor(v)[dist.get_rank():dist.get_rank() + 1].to(dev)
                for k, v in dbrx_ep_batch().items()}
        with torch.no_grad(), use_plan(plan):
            tf.loss_fn(own, params, mine)
        dropped, assigned = int(layer.stats["dropped"]), int(layer.stats["assignments"])
        layer.stats = None
    finally:
        clock.close()
    del state, params
    return {"loss": losses, "ms": ms, "coll": coll, "launches": counts,
            "expert_bytes": expert_bytes, "w": picked if dist.get_rank() == 0 else None,
            "dropped": dropped, "assignments": assigned}


def reduced_cfg(arch: str):
    cfg = get_config(arch, reduced=True).replace(attn_impl="pallas")
    return cfg.replace(moe_impl="ep", capacity_factor=8.0) if cfg.num_experts else cfg


def reduced_batch(cfg, step: int) -> dict:
    if cfg.input_mode == "tokens":
        return TokenStream(cfg.vocab_size, seed=26).batch(step, 8, 32)
    return train_lm.frame_batches(cfg, 26)(step, 8, 32)


def reduced_run(arch: str, device, plan) -> dict:
    """Phase 26's run of a reduced config: 3 moment-tier steps at 2
    microbatches of 4; sharded over the rung under ``plan``, else whole with
    the batch laid out for 2 ranks (experts in 2 routing groups: one per
    rank's share, as the ranks' aux losses average)."""
    cfg = reduced_cfg(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(26), "cpu").to(device)
    opt = sgd(momentum=0.9)
    if plan is not None:
        params = place(params, plan)
        step = make_train_step(cfg, opt, 2, plan=plan)
    else:
        step = make_train_step(cfg, opt, 2, dp_size=SHARD_WORLD,
                               moe_groups=SHARD_WORLD if cfg.num_experts else 1)
    state = init_state(params, opt)
    losses = []
    for i in range(3):
        state, metrics = step(state, reduced_batch(cfg, i), 0.05)
        losses.append(float(metrics["loss"]))
    return {"loss": losses, "sq_norm_sum": state.div_state.sq_norm_sum.item(),
            "params": {n: t.cpu().numpy() for n, t in whole_params(state.params).items()},
            "held": sum(p.numel() for p in state.params.parameters())}


def card_ckpt_run(device, plan, root: str | None) -> dict:
    """25d: reduced Yi-6B (float32) two steps, saved through the rung into
    ``root``/sharded; the same state gathered and saved by one process into
    ``root``/whole; then its third step's loss."""
    from repro_torch import interop
    from repro_torch.elastic.reshard import unshard_state

    cfg = reduced_cfg("yi-6b")
    opt = sgd(momentum=0.9)
    params = tf.init_params(cfg, torch.Generator().manual_seed(25), "cpu").to(device)
    params = place(params, plan)
    state = init_state(params, opt)
    step = make_train_step(cfg, opt, 2, plan=plan)
    for i in range(2):
        state, _ = step(state, reduced_batch(cfg, i), 0.05)
    ref = interop.reference_state(state)
    tree = {"params": ref.params, "opt_state": ref.opt_state, "div_state": ref.div_state}
    mesh = plan.mesh
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(root, "sharded")).save(
        2, tree, group=mesh.group(mesh.axis_names), root=mesh.root)
    save_s = time.perf_counter() - t0
    state3, metrics = step(copy.deepcopy(state), reduced_batch(cfg, 2), 0.05)
    whole = unshard_state(state)
    if dist.get_rank() == mesh.root:
        ref = interop.reference_state(whole)
        CheckpointManager(os.path.join(root, "whole")).save(
            2, {"params": ref.params, "opt_state": ref.opt_state, "div_state": ref.div_state})
    return {"next_loss": float(metrics["loss"]), "save_s": save_s}


def card_restore_one(device, root: str) -> float:
    """25d in the parent: 25d's sharded save restored onto one process (a
    state from other weights first), its third step's loss."""
    from repro_torch import interop

    cfg = reduced_cfg("yi-6b")
    opt = sgd(momentum=0.9)
    state = init_state(tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu").to(device),
                       opt)
    ref = interop.reference_state(state, target=True)
    out, _ = CheckpointManager(os.path.join(root, "sharded")).restore(
        {"params": ref.params, "opt_state": ref.opt_state, "div_state": ref.div_state})
    state = interop.load_reference_state(state, step=2, **out)
    step = make_train_step(cfg, opt, 2, dp_size=SHARD_WORLD)
    state, metrics = step(state, reduced_batch(cfg, 2), 0.05)
    return float(metrics["loss"])


def rank_sharded(dev, args) -> dict:
    """25a, 25c, 25d, 26, 30 and 33 on the ranks of one gloo world."""
    plan = data_plan(dev)
    out = {"backend": dist.get_backend(), "yi": rank_shard_yi(dev, plan, args["yi_whole"])}
    free()
    dist.barrier()
    out["dbrx"] = rank_dbrx_ep(dev, plan)
    free()
    dist.barrier()
    out["ckpt"] = card_ckpt_run(dev, plan, args["ckpt_dir"])
    out["reduced"] = {arch: reduced_run(arch, dev, plan) for arch in SHARD_REDUCED}
    # phase 30's ranks: the same world (one spawn less), reported after phase 29
    free()
    dist.barrier()
    out["tp"] = rank_tp(dev, {"whole": args["tp_whole"]})
    # phase 33's, reported after phase 32
    free()
    dist.barrier()
    out["mamba_tp"] = rank_mamba_tp(dev, {"whole": args["mamba_whole"]})
    return out


def rank_sharded_world_one(dev, args) -> dict:
    """25b, NCCL at a world of one: 25a's first step with whole state and
    on a 1-rank plan (its specs shard nothing: every collective is an
    identity)."""
    cfg = shard_yi_cfg()
    batch = TokenStream(cfg.vocab_size, seed=1).batch(0, SHARD_MICRO, SHARD_SEQ)
    runs = {}
    for tag, plan in (("base", None), ("ranked", data_plan(dev))):
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if plan is not None:
            params = place(params, plan)
        state = init_state(params, sgd(momentum=0.9))
        step = make_train_step(cfg, sgd(momentum=0.9), 1, plan=plan)
        state, metrics = step(state, batch, TRAIN_LR)
        runs[tag] = (float.hex(float(metrics["loss"])),
                     [p.detach().clone() for p in params.parameters()])
        del state, params
    same = all(torch.equal(a, b) for a, b in zip(runs["base"][1], runs["ranked"][1]))
    return {"backend": dist.get_backend(), "loss": [runs["base"][0], runs["ranked"][0]],
            "same": same and runs["base"][0] == runs["ranked"][0]}


RANK_JOBS.update(sharded=rank_sharded, sharded_world_one=rank_sharded_world_one)


def coll_line(coll: dict) -> str:
    return "; ".join(f"{n} {coll['calls'][n]} calls, {coll['bytes'][n] / 1e9:.3f} GB, "
                     f"{coll['ms'][n]:.1f} ms" for n in COLLECTIVES if coll["calls"][n])


#: phase 25's peaks and collectives by rank, which phase 30 prints beside its own
PHASE25: dict = {}
#: phase 30's one-process run and its ranks' results, run within phase 25's
#: spawn (the same gloo world) and reported after phase 29
PHASE30: dict = {}


def sharded_phase(dev: str = "cuda") -> dict[str, dict]:
    """Phases 25 and 26; returns the launch counts of the sharded paths,
    summed over the ranks."""
    phase(f"25. the training state sharded over 2 gloo ranks on the one card: Yi-6B widths "
          f"at {SHARD_LAYERS} of 32 layers, dbrx-132b's experts over an explicit all-to-all")
    t_phase = time.perf_counter()
    cfg = shard_yi_cfg()
    mine, whole_bytes, mine_params = reckoned_state_bytes(cfg, SHARD_WORLD)
    n_params = sum(p.numel() for p in tf.build(cfg, "meta").parameters())
    print(f"  (a) reckoned from infer_pspecs on a (data 2) rung (fsdp = ep = data, no tp): "
          f"{mine_params / 1e9:.4f} B parameters per rank of {n_params / 1e9:.4f} B "
          f"({100 * mine_params / n_params:.1f}%; lm_head (V -> tp) stays whole); state "
          f"(parameters, momenta bf16, grad_sum float32) {mine / 1e9:.3f} GB per rank of "
          f"{whole_bytes / 1e9:.3f} GB")
    root = ckpt_root("sharded")
    yi_whole_path = os.path.join(root, "yi_whole.pt")
    os.makedirs(root, exist_ok=True)
    try:
        t0 = time.perf_counter()
        whole = shard_yi_whole(yi_whole_path, dev)
        if whole["bytes"] != whole_bytes:
            raise AssertionError(f"the whole run holds {whole['bytes']} bytes, reckoned "
                                 f"{whole_bytes}")
        print(f"  (a) the whole run on one process: losses "
              f"{[round(x, 5) for x in whole['loss']]}, batches {whole['batch']}, step ms "
              f"{[round(x, 1) for x in whole['ms']]}, peak {whole['peak_gib']:.2f} GiB "
              f"({time.perf_counter() - t0:.1f} s)")
        dbrx_ref = dbrx_one_process(dev)
        t0 = time.perf_counter()
        one = spawn_ranks("sharded_world_one", "nccl", 1, {})[0]
        if not one["same"]:
            raise AssertionError(f"(b) world 1: losses {one['loss']} or parameters differ")
        print(f"  (b) [{one['backend']}, world 1, rank 0] 25a's first step on a 1-rank "
              f"plan (nothing sharded: every collective an identity): loss {one['loss'][1]}, "
              f"the unsharded run's to the bit, parameters too "
              f"({time.perf_counter() - t0:.1f} s with the spawn)")
        tp_whole_path = os.path.join(root, "yi_tp_whole.pt")
        PHASE30["one"] = tp_one_process(tp_whole_path, dev)
        mamba_whole_path = os.path.join(root, "falcon_tp_whole.pt")
        t0 = time.perf_counter()
        PHASE33["one"] = mamba_tp_one_process(mamba_whole_path, dev)
        PHASE33["one_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = spawn_ranks("sharded", "gloo", SHARD_WORLD,
                          {"yi_whole": yi_whole_path, "ckpt_dir": root,
                           "tp_whole": tp_whole_path, "mamba_whole": mamba_whole_path})
        spawn_s = time.perf_counter() - t0
        PHASE30["res"] = {r: res[r].pop("tp") for r in res}
        PHASE33["res"] = {r: res[r].pop("mamba_tp") for r in res}
        restored = card_restore_one(dev, root)
        same_files = all(
            open(os.path.join(root, "sharded", "step_0000000002", k, f), "rb").read()
            == open(os.path.join(root, "whole", "step_0000000002", k, f), "rb").read()
            for k in ("params", "opt_state", "div_state")
            for f in sorted(os.listdir(os.path.join(root, "whole", "step_0000000002", k))))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = dict(sorted(res.items()))
    tags = {r: f"[{res[r]['backend']}, world {SHARD_WORLD}, rank {r}]" for r in res}
    layers = cfg.num_layers
    for r in res:
        y = res[r]["yi"]
        if y["bytes"] != mine or y["params"] != mine_params:
            raise AssertionError(f"{tags[r]} holds {y['bytes']} bytes ({y['params']} "
                                 f"parameters), reckoned {mine} ({mine_params})")
        losses = [s["loss"] for s in y["steps"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, whole["loss"]))
        batches = [s["batch"] for s in y["steps"]]
        if batches != whole["batch"] or y["buckets"] != whole["buckets"] \
                or rel > SHARD_LOSS_RTOL:
            raise AssertionError(f"{tags[r]} batches {batches} buckets {y['buckets']} losses "
                                 f"{losses} against {whole}")
        if r == 0 and y["param_gap"] > SHARD_PARAM_ATOL:
            raise AssertionError(f"{tags[r]} gathered parameters {y['param_gap']:.3e} from "
                                 f"the whole run's (tol {SHARD_PARAM_ATOL})")
        n_micro = sum(y["num_micro"])
        want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
                "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
        if y["launches"] != want:
            raise AssertionError(f"{tags[r]} launches {y['launches']}, expected {want}")
        attn_routes(y["launches"], y["plan"], what=f"{tags[r]} sharded Yi", routes=y["routes"])
        PHASE25.setdefault("peak_gib", {})[r] = y["peak_gib"]
        PHASE25.setdefault("coll", {})[r] = [st["coll"] for st in y["steps"]]
        print(f"  (a) {tags[r]} resident state {y['bytes'] / 1e9:.3f} GB = the reckoning "
              f"({100 * y['bytes'] / whole_bytes:.1f}% of the whole {whole_bytes / 1e9:.3f} GB), "
              f"{y['params'] / 1e9:.4f} B parameters; peak {y['peak_gib']:.2f} GiB (the whole "
              f"run's {whole['peak_gib']:.2f})")
        for i, st in enumerate(y["steps"]):
            c = st["coll"]
            coll_ms = sum(c["ms"][n] for n in COLLECTIVES)
            print(f"    step {i + 1}: batch {st['batch']} ({y['num_micro'][i]} microbatches), "
                  f"loss {st['loss']:.5f} (whole {whole['loss'][i]:.5f}), {st['ms']:.1f} ms, "
                  f"collectives {coll_ms:.1f} ms ({100 * coll_ms / st['ms']:.1f}%): "
                  f"{coll_line(c)}")
        print(f"    losses within {rel:.3e} relative (tol {SHARD_LOSS_RTOL}), batches and "
              f"buckets {y['buckets']} the whole run's"
              + (f", gathered parameters within {y['param_gap']:.3e} (tol {SHARD_PARAM_ATOL})"
                 if r == 0 else "")
              + f"; launches {y['launches']} (= {2 * layers}, {layers}, {layers} x {n_micro} "
              f"microbatches), all three on tc")
        g = y["gram"]
        gram_want = {"chunk_attention": 2 * layers, "paged_decode_attention": 0,
                     "flash_dq": layers, "flash_dkv": layers, "psgn_direct": 0,
                     "psgn_gram": 3 * layers, "psgn_fused": 2, "psgn_split": 0,
                     "quantize_int8": 0}
        if {k: g["launches"].get(k, 0) for k in gram_want} != gram_want \
                or not np.isfinite(g["sq_norm_sum"]) or g["sq_norm_sum"] <= 0:
            raise AssertionError(f"{tags[r]} gram step: launches {g['launches']}, expected "
                                 f"{gram_want}; sq_norm_sum {g['sq_norm_sum']}")
        print(f"    gram tier, 1 step (batch {SHARD_MICRO}): loss {g['loss']:.5f}, sq_norm_sum "
              f"{g['sq_norm_sum']:.6e}, {g['ms']:.1f} ms; launches {g['launches']} (psgn "
              f"{3 * layers} gram, 2 fused, on {g['routes']}); {coll_line(g['coll'])}")
    # (c) dbrx-132b's experts resident, the tokens over all_to_all_single
    ref = dbrx_ref
    d0 = res[0]["dbrx"]
    for r in res:
        d = res[r]["dbrx"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(d["loss"], ref["loss"]))
        width = torch.finfo(getattr(torch, DBRX.param_dtype)).bits // 8
        want_bytes = DBRX.num_experts * 3 * DBRX.d_model * DBRX.d_ff * width // SHARD_WORLD
        if rel > SHARD_LOSS_RTOL or d["expert_bytes"] != want_bytes \
                or d["coll"]["calls"]["all_to_all_single"] == 0:
            raise AssertionError(f"{tags[r]} dbrx ep: losses {d['loss']} against {ref['loss']}, "
                                 f"expert bytes {d['expert_bytes']} ({want_bytes}), "
                                 f"all-to-alls {d['coll']['calls']}")
        print(f"  (c) {tags[r]} dbrx-132b, 1 layer, moe_impl='ep', 8 of 16 experts resident "
              f"({d['expert_bytes'] / 1e9:.3f} GB); forward loss {d['loss'][0]:.5f} and after "
              f"one step {d['loss'][1]:.5f} against moe_apply on one process "
              f"{[round(x, 5) for x in ref['loss']]}: within {rel:.3e} (tol {SHARD_LOSS_RTOL}); "
              f"step ms {[round(x, 1) for x in d['ms']]}; {coll_line(d['coll'])}; at the "
              f"config's capacity {DBRX.capacity_factor}: {d['dropped']} of "
              f"{d['assignments']} assignments dropped on this rank")
    gap = max((d0["w"][n] - ref["w"][n]).abs().max().item() for n in ref["w"])
    if gap > SHARD_PARAM_ATOL:
        raise AssertionError(f"dbrx ep: gathered parameters {gap:.3e} from one process")
    print(f"  (c) after two steps w_up, q and the embedding, gathered, within {gap:.3e} of "
          f"one process (tol {SHARD_PARAM_ATOL})")
    # (d) checkpoints
    ck = res[0]["ckpt"]
    rel = abs(restored - ck["next_loss"]) / abs(ck["next_loss"])
    if not same_files or rel > 1e-5:
        raise AssertionError(f"(d) files equal {same_files}; the restored step {restored} "
                             f"against {ck['next_loss']}")
    print(f"  (d) reduced Yi-6B (float32): the 2-rank sharded save ({ck['save_s']:.2f} s, "
          f"each leaf gathered as rank 0 writes it) equals the one-process save of the "
          f"gathered state byte for byte: {same_files}; restored onto one process, step 3's "
          f"loss {restored:.6f} against the ranks' {ck['next_loss']:.6f} (within {rel:.2e}, "
          f"tol 1e-5)")
    print(f"  phase 25: {time.perf_counter() - t_phase:.1f} s (the gloo spawn {spawn_s:.1f} s, "
          f"phase 30's ranks and one-process run included)")

    phase("26. the reduced dense, MoE (moe_impl='ep'), Mamba and encoder configs sharded on "
          "2 gloo ranks (card, kernels) against one process on the CPU (whole state)")
    for arch in SHARD_REDUCED:
        cpu = reduced_run(arch, "cpu", None)
        for r in res:
            got = res[r]["reduced"][arch]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], cpu["loss"]))
            err = max(float(np.abs(got["params"][n] - v).max()) for n, v in cpu["params"].items())
            sq = abs(got["sq_norm_sum"] - cpu["sq_norm_sum"]) / cpu["sq_norm_sum"]
            held = sum(v.size for v in cpu["params"].values())
            if rel > SHARD_CPU_TOL or err > SHARD_CPU_TOL or sq > SHARD_CPU_TOL \
                    or got["held"] >= held:
                raise AssertionError(f"{tags[r]} {arch}: losses {got['loss']} against "
                                     f"{cpu['loss']}, parameters {err:.3e}, sq {sq:.3e}, "
                                     f"held {got['held']} of {held}")
            if r == 0:
                print(f"  {arch} {tags[r]}: holds {got['held']} of {held} parameters; losses "
                      f"within {rel:.3e} relative, sq_norm_sum {sq:.3e}, gathered parameters "
                      f"within {err:.3e} (tol {SHARD_CPU_TOL})")
    return {"sharded training (ranks)": {
                k: sum(res[r]["yi"]["launches"][k] for r in res) for k in res[0]["yi"]["launches"]},
            "sharded gram step (ranks)": {
                k: sum(res[r]["yi"]["gram"]["launches"][k] for r in res)
                for k in res[0]["yi"]["gram"]["launches"]},
            "sharded dbrx ep (ranks)": {
                k: sum(res[r]["dbrx"]["launches"][k] for r in res)
                for k in res[0]["dbrx"]["launches"]}}


# ---------------------------------------------------------------------------
# phases 27-28: elastic serving, on the card's virtual devices and on ranks
# ---------------------------------------------------------------------------

# phase 27: Yi-6B at full depth on the default ladder (8 virtual devices)
LOCAL_KW = dict(max_slots=8, max_seq=1024, block_size=16, prompt_granule=16,
                prefill_chunk=256)
LOCAL_LENS, LOCAL_NEW = (64, 300, 150, 96, 200, 128), (32, 16, 16, 16, 16, 16)
# phase 28: Yi-6B widths on a 2-rank ladder, prompts in one chunk, at 2 layers
# (half phase 25's depth: a decode step's block gathers scale with the depth,
# and the whole script must keep inside its time limit)
ELASTIC_LAYERS, ELASTIC_WORLD = 2, 2
ELASTIC_KW = dict(max_slots=8, max_seq=128, block_size=16, prompt_granule=16,
                  prefill_chunk=64)
# the first request outlives the others, so the bucket falls back to 1: rungs 0, 1, 0
ELASTIC_LENS, ELASTIC_NEW = (40, 64, 17, 52, 33, 60), (24, 8, 8, 8, 8, 8)
#: the kinds of collective an elastic decode step issues on a rank rung
SERVE_KINDS = ("parameter gathers", "pool entries", "tokens", "policy")


def elastic_requests(vocab: int, lens, new, seed: int) -> list[Request]:
    r = np.random.default_rng(seed)
    return [Request(prompt=r.integers(1, vocab, size=n).astype(np.int32), max_new_tokens=m)
            for n, m in zip(lens, new)]


def ramp(engine: ServeEngine, reqs: list[Request], waves=(1, 2)) -> list[list[int]]:
    """A ramping trace: ``waves[0]`` requests, two steps, ``waves[1]`` more,
    two steps, the rest, drained; the tokens in submit order."""
    rids, start = [], 0
    for n in waves:
        rids += [engine.submit(q) for q in reqs[start:start + n]]
        start += n
        for _ in range(2):
            engine.step()
    rids += [engine.submit(q) for q in reqs[start:]]
    while engine.step():
        pass
    engine.pool.check()
    return [engine.result(rid).tokens.tolist() for rid in rids]


def rung_steps(engine: ServeEngine, extra=None) -> list[dict]:
    """Wrap ``engine.step`` to record, per step, its seconds (the card
    synchronised), prefill chunks run, decode steps run and the live rung
    after it; ``extra()`` joins each record."""
    recs, inner = [], engine.step

    def step():
        c0, s0 = engine.stats.prefill_chunks, engine.stats.steps
        before = extra() if extra else None
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = inner()
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t, "chunks": engine.stats.prefill_chunks - c0,
               "decoded": engine.stats.steps - s0, "rung": getattr(engine.rung, "index", None)}
        if extra:
            rec["extra"] = (before, extra())
        recs.append(rec)
        return more

    engine.step = step
    return recs


def rung_medians(recs: list[dict]) -> dict:
    """Per rung: the median decode-only step and the median chunk (the
    rung's decode median subtracted from a step that decoded too), in ms,
    None where the rung ran none."""
    out = {}
    for rung in sorted({r["rung"] for r in recs}):
        mine = [r for r in recs if r["rung"] == rung]
        dec = [1e3 * r["s"] for r in mine if r["chunks"] == 0 and r["decoded"]]
        d = statistics.median(dec) if dec else None
        ch = [(1e3 * r["s"] - ((d or 0.0) if r["decoded"] else 0.0)) / r["chunks"]
              for r in mine if r["chunks"]]
        out[rung] = (d, statistics.median(ch) if ch else None, len(dec), len(ch))
    return out


def medians_line(med: dict) -> str:
    return "; ".join(
        f"rung {k}: decode {'-' if d is None else f'{d:.2f}'} ms ({nd} steps), chunk "
        f"{'-' if c is None else f'{c:.2f}'} ms ({nc})" for k, (d, c, nd, nc) in med.items())


def reshard_seconds(tracer) -> list[float]:
    return [e["dur"] / 1e6 for e in tracer.events
            if e.get("ph") == "X" and e["name"] == "reshard"]


def elastic_local_phase() -> dict:
    """Phase 27; returns the launch counts of the ladder's run."""
    from repro_torch.elastic import MeshLadder
    from repro_torch.obs import Tracer

    phase("27. elastic serving on the card's 8 virtual devices: Yi-6B, 32 layers, bf16, "
          "ServeEngine(elastic=MeshLadder()) on a ramping trace")
    cfg = YI
    params, _ = init_timed(cfg)  # phase 4's weights (the same seed)
    reqs = elastic_requests(cfg.vocab_size, LOCAL_LENS, LOCAL_NEW, seed=27)
    base = ServeEngine(cfg, params, device="cuda", **LOCAL_KW)
    base_recs = rung_steps(base)
    want = ramp(base, reqs)
    base_med = rung_medians(base_recs)
    del base
    ladder = MeshLadder(granule=1)
    tracer = Tracer()
    engine = ServeEngine(cfg, params, elastic=ladder, tracer=tracer, **LOCAL_KW)
    recs = rung_steps(engine)
    kernels.reset_launch_counts()
    got = ramp(engine, reqs)
    counts = kernels.launch_counts()
    st = engine.stats
    want_counts = {"chunk_attention": cfg.num_layers * st.prefill_chunks,
                   "paged_decode_attention": cfg.num_layers * st.steps,
                   "flash_dq": 0, "flash_dkv": 0, **NO_PSGN}
    if got != want:
        raise AssertionError(f"elastic tokens {got} against the engine with no ladder {want}")
    if counts != want_counts:
        raise AssertionError(f"launches {counts}, expected {want_counts}")
    if st.reshards < 2 or st.compiles != len(set(zip(st.buckets, st.rungs))) \
            or any(r != ladder.rung_for_batch(b).index for b, r in zip(st.buckets, st.rungs)):
        raise AssertionError(f"reshards {st.reshards}, buckets {st.buckets}, rungs {st.rungs}")
    attn_routes(counts, plan_of(cfg, torch.bfloat16), what="elastic serving")
    rs = reshard_seconds(tracer)
    print(f"  ladder dp={ladder.widths} on {ladder.full.plan.mesh!r}; {len(reqs)} requests "
          f"(prompts {list(LOCAL_LENS)}, {list(LOCAL_NEW)} new) in waves of 1, 2 and 3")
    print(f"  tokens identical to the same trace with no ladder ({sum(map(len, got))} tokens)")
    print(f"  stats.rungs {st.rungs} (buckets {st.buckets}), {st.reshards} reshards, "
          f"compiles {st.compiles} = distinct (bucket, rung) pairs, hits {st.bucket_hits}")
    print(f"  reshard seconds per transition: {[f'{x:.6f}' for x in rs]} (no byte moves)")
    print(f"  by rung: {medians_line(rung_medians(recs))}")
    print(f"  no ladder: {medians_line(base_med)}")
    print(f"  launches {counts} (= {cfg.num_layers} x {st.prefill_chunks} chunks, "
          f"{cfg.num_layers} x {st.steps} decode steps, no backward)")
    del engine, params
    free()
    return counts


def pool_digest(pages: dict) -> str:
    """A digest of every pool block but the sentinel block 0 (inactive lanes
    write garbage there)."""
    import hashlib

    h = hashlib.sha256()
    for entry in pages.values():
        for x in entry.values():
            h.update(x[:, 1:].contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


class ServeClock(CollectiveClock):
    """``CollectiveClock`` plus ``broadcast`` (the state sent to ranks that
    enter a rung)."""

    ARG = {**CollectiveClock.ARG, "broadcast": 0}


class PartClock:
    """Per named part of a serving step (a wrapped function): its calls, and
    the ms and bytes of the collectives a ``ServeClock`` saw inside it (a
    ``wall`` part, the policy's pickled broadcast the clock does not see,
    by its wall time)."""

    def __init__(self, clock, kinds):
        self.clock = clock
        self.part = {k: {"ms": 0.0, "bytes": 0, "calls": 0} for k in kinds}

    def wrap(self, kind: str, fn, wall: bool = False):
        def run(*a, **kw):
            before = self.clock.snapshot()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            after = self.clock.snapshot()
            rec = self.part[kind]
            rec["calls"] += 1
            rec["ms"] += (1e3 * (time.perf_counter() - t) if wall else
                          sum(after["ms"][n] - before["ms"][n] for n in ServeClock.ARG))
            rec["bytes"] += sum(after["bytes"][n] - before["bytes"][n] for n in ServeClock.ARG)
            return out
        return run

    def snapshot(self) -> dict:
        return copy.deepcopy(self.part)


def rank_elastic_serve(dev, args) -> dict:
    """28 on a gloo rank: Yi-6B at ``ELASTIC_LAYERS`` layers served on a
    2-rank ladder through the ramping trace, per-step collectives by kind."""
    from repro_torch.dist import sharding
    from repro_torch.elastic import MeshLadder
    from repro_torch.obs import Tracer
    from repro_torch.serve import engine as engine_mod

    cfg = YI.replace(num_layers=ELASTIC_LAYERS)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ladder = MeshLadder(rank_devices(dev), granule=1)
    tracer = Tracer()
    engine = ServeEngine(cfg, params, elastic=ladder, tracer=tracer, **ELASTIC_KW)
    del params
    clock = ServeClock()
    parts = PartClock(clock, SERVE_KINDS[1:])
    engine._share_entries = parts.wrap("pool entries", engine._share_entries)
    engine._agree = parts.wrap("tokens", engine._agree)
    inner_bcast = engine_mod.broadcast_object
    engine_mod.broadcast_object = parts.wrap("policy", inner_bcast, wall=True)
    calls = {"decode": 0, "chunk": 0}
    inner_decode, inner_chunk = tf.decode_step, tf.prefill_chunk

    def decode(*a, **kw):
        calls["decode"] += 1
        return inner_decode(*a, **kw)

    def chunk(*a, **kw):
        calls["chunk"] += 1
        return inner_chunk(*a, **kw)

    held = {}

    def snap():
        lay = sharding.layout_of(engine.params)
        if lay is not None and "params" not in held:
            held["params"] = sum(p.numel() for p in engine.params.parameters())
            held["bytes"] = sum(p.numel() * p.element_size() for p in engine.params.parameters())
        if engine.rung.index == ladder.full.index:
            held["pool"] = pool_digest(engine._pages)
        return clock.snapshot(), parts.snapshot()

    recs = rung_steps(engine, snap)
    reqs = elastic_requests(cfg.vocab_size, ELASTIC_LENS, ELASTIC_NEW, seed=28)
    tf.decode_step, tf.prefill_chunk = decode, chunk
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        toks = ramp(engine, reqs, waves=(1,))
        torch.cuda.synchronize()
    finally:
        tf.decode_step, tf.prefill_chunk = inner_decode, inner_chunk
        engine_mod.broadcast_object = inner_bcast
        clock.close()
    wall = time.perf_counter() - t0
    st = engine.stats
    steps = []
    for r in recs:
        (c0, p0), (c1, p1) = r.pop("extra")
        kinds = {k: {m: p1[k][m] - p0[k][m] for m in ("ms", "bytes", "calls")}
                 for k in SERVE_KINDS[1:]}
        tot = {m: sum(c1[m][n] - c0[m][n] for n in ServeClock.ARG)
               for m in ("ms", "bytes", "calls")}
        # the rest of the clock's collectives: the blocks' and the embedding's gathers
        kinds["parameter gathers"] = {
            m: tot[m] - kinds["pool entries"][m] - kinds["tokens"][m]
            for m in ("ms", "bytes", "calls")}
        steps.append({**r, "coll": kinds})
    return {"tokens": toks, "rungs": list(st.rungs), "buckets": list(st.buckets),
            "reshards": st.reshards, "steps": steps, "reshard_s": reshard_seconds(tracer),
            "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
            "calls": calls, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "wall_s": wall, "backend": dist.get_backend(), **held}


def rank_elastic_world_one(dev, args) -> dict:
    """28's world of one on NCCL: the 2-rank ladder's trace on a 1-rank
    ladder (a rung of one rank shards nothing; every token agreed over the
    one-rank group) and on the engine with no ladder: tokens and pools."""
    from repro_torch.elastic import MeshLadder

    cfg = YI.replace(num_layers=ELASTIC_LAYERS)
    reqs = elastic_requests(cfg.vocab_size, ELASTIC_LENS, ELASTIC_NEW, seed=28)
    out = {"backend": dist.get_backend()}
    for tag, ladder in (("base", None), ("ranked", MeshLadder(rank_devices(dev), granule=1))):
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        kw = {"elastic": ladder} if ladder is not None else {"device": dev}
        engine = ServeEngine(cfg, params, **kw, **ELASTIC_KW)
        out[tag] = {"tokens": ramp(engine, reqs, waves=(1,)), "pool": pool_digest(engine._pages)}
        del engine, params
    out["same"] = out["base"] == out["ranked"]
    return out


def rank_elastic_serve_tp(dev, args) -> dict:
    """28, then 31 (reported after phase 30), on the ranks of one gloo
    world (one spawn less)."""
    out = rank_elastic_serve(dev, args)
    free()
    dist.barrier()
    out["tp_serve"] = rank_tp_serve(dev, args)
    return out


RANK_JOBS.update(elastic_serve_tp=rank_elastic_serve_tp,
                 elastic_world_one=rank_elastic_world_one)


def elastic_rank_report(rk: int, got: dict, want: list, mine_params: int, plan: dict) -> None:
    """Hold one rank's phase-28 run (tokens, resident parameters, launches,
    rungs, routes) and print it."""
    tag = f"[{got['backend']}, world {ELASTIC_WORLD}, rank {rk}]"
    want_counts = {"chunk_attention": ELASTIC_LAYERS * got["calls"]["chunk"],
                   "paged_decode_attention": ELASTIC_LAYERS * got["calls"]["decode"],
                   "flash_dq": 0, "flash_dkv": 0, **NO_PSGN}
    if got["tokens"] != want:
        raise AssertionError(f"{tag} tokens {got['tokens']} against one process {want}")
    if got.get("params") != mine_params:
        raise AssertionError(f"{tag} holds {got.get('params')} parameters, reckoned "
                             f"{mine_params}")
    if got["launches"] != want_counts or 0 in got["calls"].values():
        raise AssertionError(f"{tag} launches {got['launches']}, expected {want_counts}")
    if got["reshards"] < 2 or set(got["rungs"]) != {0, 1}:
        raise AssertionError(f"{tag} rungs {got['rungs']}, reshards {got['reshards']}")
    attn_routes(got["launches"], plan, what=f"{tag} elastic serving", routes=got["routes"])
    print(f"  (c) {tag} tokens equal one process's; resident parameters on the 2-rank "
          f"rung {got['bytes'] / 1e9:.3f} GB ({got['params'] / 1e9:.4f} B) = the "
          f"reckoning; peak {got['peak_gib']:.2f} GiB; {got['wall_s']:.1f} s")
    print(f"    stats.rungs {got['rungs']} (buckets {got['buckets']}), reshard seconds "
          f"{[round(x, 3) for x in got['reshard_s']]}")
    print(f"    by rung: {medians_line(rung_medians(got['steps']))}")
    dec = [st for st in got["steps"] if st["rung"] == 1 and st["decoded"]
           and not st["chunks"]]
    step_ms = statistics.median(1e3 * st["s"] for st in dec)
    for kind in SERVE_KINDS:
        med = {m: statistics.median(st["coll"][kind][m] for st in dec)
               for m in ("calls", "bytes", "ms")}
        print(f"    a decode step on rung 1 ({len(dec)} steps, median), {kind}: "
              f"{med['calls']:.0f} calls, {med['bytes'] / 1e9:.4f} GB, {med['ms']:.1f} ms "
              f"({100 * med['ms'] / step_ms:.1f}% of the step's {step_ms:.1f})")
    print(f"    launches {got['launches']} (= {ELASTIC_LAYERS} x {got['calls']['chunk']} "
          f"chunks, {ELASTIC_LAYERS} x {got['calls']['decode']} decode steps this rank ran)")


def elastic_ranks_phase() -> dict:
    """Phase 28; returns the launch counts of the ranks' run, summed."""
    phase(f"28. elastic serving over {ELASTIC_WORLD} gloo ranks sharing the one card: Yi-6B "
          f"widths at {ELASTIC_LAYERS} of 32 layers on MeshLadder(rank_devices, granule=1), "
          f"the parameters sharded on the 2-rank rung")
    t_phase = time.perf_counter()
    cfg = YI.replace(num_layers=ELASTIC_LAYERS)
    _, _, mine_params = reckoned_state_bytes(cfg, ELASTIC_WORLD)
    n_params = sum(p.numel() for p in tf.build(cfg, "meta").parameters())
    print(f"  (a) reckoned from infer_pspecs on the (data 2) rung: {mine_params / 1e9:.4f} B "
          f"parameters a rank of {n_params / 1e9:.4f} B, {2 * mine_params / 1e9:.3f} GB in bf16")
    # the kernels at the shapes a rank launches them with: its rows of the
    # bucket (1, 2, 4 of 8) and a one-chunk prompt
    r = np.random.default_rng(28)
    n_max = -(-(ELASTIC_KW["max_seq"] + ELASTIC_KW["max_seq"] // 2) // 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (1, 2, 4):
        args = decode_inputs(r, torch.bfloat16, b=b, blk=16, n_max=n_max, nb=1 + b * n_max,
                             kv=cfg.num_kv_heads, h=cfg.num_heads, hd=cfg.resolved_head_dim,
                             max_len=n_max * 16)
        decode_case(f"a rank's rows bf16 (B {b}, block 16, {n_max} table entries, "
                    f"{cfg.num_heads}/{cfg.num_kv_heads} heads of hd 128; decode_plan "
                    f"{kattn.decode_plan(b, cfg.num_kv_heads, n_max, 16, sms)} splits)", args)
    chunk_case("a rank rung's prompt bf16 (C 64, no prior, 32/4 heads of hd 128)",
               chunk_inputs(r, torch.bfloat16, b=1, c=64, prior_real=0, prior_blocks=0,
                            blk=16, h=cfg.num_heads, kv=cfg.num_kv_heads,
                            hd=cfg.resolved_head_dim))
    reqs = elastic_requests(cfg.vocab_size, ELASTIC_LENS, ELASTIC_NEW, seed=28)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    base = ServeEngine(cfg, params, device="cuda", **ELASTIC_KW)
    base_recs = rung_steps(base)
    want = ramp(base, reqs, waves=(1,))
    print(f"  (a) one process, whole parameters: {medians_line(rung_medians(base_recs))}")
    del base, params
    free()
    t0 = time.perf_counter()
    one = spawn_ranks("elastic_world_one", "nccl", 1, {})[0]
    if not one["same"] or one["base"]["tokens"] != want:
        raise AssertionError(f"(b) world 1: {one} against {want}")
    print(f"  (b) [{one['backend']}, world 1, rank 0] the trace on a 1-rank ladder: tokens and "
          f"pool bytes (the sentinel block aside) the engine's with no ladder, to the bit "
          f"({time.perf_counter() - t0:.1f} s with the spawn)")
    t0 = time.perf_counter()
    res = dict(sorted(spawn_ranks("elastic_serve_tp", "gloo", ELASTIC_WORLD, {}).items()))
    spawn_s = time.perf_counter() - t0
    PHASE31["res"] = {rk: res[rk].pop("tp_serve") for rk in res}
    plan = plan_of(cfg, torch.bfloat16)
    for rk, got in res.items():
        elastic_rank_report(rk, got, want, mine_params, plan)
        d = rung_medians(got["steps"]).get(1, (None,))[0]
        PHASE31.setdefault("phase28", {})[rk] = "-" if d is None else f"{d:.2f} ms"
    if res[0]["pool"] != res[1]["pool"]:
        raise AssertionError("the ranks' pools differ after their last step on the 2-rank rung")
    print(f"  (c) the pools equal across the ranks after the last step on the 2-rank rung; "
          f"phase 28: {time.perf_counter() - t_phase:.1f} s (the gloo spawn {spawn_s:.1f} s, "
          f"phase 31's ranks included)")
    return {k: sum(res[r]["launches"][k] for r in res) for k in res[0]["launches"]}


# ---------------------------------------------------------------------------
# phase 30: tensor-parallel training on ranks
# ---------------------------------------------------------------------------

# phase 25's cut on a (data 1, model 2) rung: 3 moment-tier steps, then 2 gram-tier
TP_WORLD, TP_GRAM_STEPS = 2, 2
#: phase 30's peak a rank and step ms with the head and the embedding
#: gathered whole on each rank (the vocabulary not split; NVIDIA H100 80GB
#: HBM3, 700.00 W), printed beside this run's
TP_WHOLE_VOCAB = {"peak_gib": 14.93, "ms": (2389.8, 2506.7)}
#: the vocab-parallel collectives phase 30 prints apart (``transformer.
#: vocab_parallel_counts``' kinds)
TP_VOCAB_KINDS = {"xent_all_gather": "logsumexp/target all-gather",
                  "input_all_gather": "embedding all-gather",
                  "head_all_reduce": "head dx all-reduce"}


#: the split residual's collectives (``dist.plan.residual_counts``' kinds),
#: which phases 30, 32 and 33 print by kind
RESIDUAL_KINDS = {"entry_all_gather": "entry all-gather",
                  "entry_reduce_scatter": "entry reduce-scatter (backward)",
                  "exit_reduce_scatter": "exit reduce-scatter",
                  "exit_all_gather": "exit all-gather (backward)",
                  "slice_all_gather": "slice all-gather (backward)"}


def residual_reckoning(cfg, plan, micro: int, bm: int, seq: int) -> dict[str, tuple[int, int]]:
    """``{kind: (calls, bytes)}`` of the split residual's collectives a tp
    rank of ``plan`` makes over ``micro`` training microbatches of ``bm``
    sequences of ``seq``: an entry all-gather per sublayer and one at the
    head, again in the remat recompute; an entry reduce-scatter behind each
    split sublayer and a split head; an exit reduce-scatter per split
    sublayer, again in the recompute but for a layer's last (the recompute
    stops once the layer's saved tensors are back), an exit all-gather in
    the backward; a slice all-gather behind each whole sublayer.  Each call
    moves the whole ``(bm, seq, d)`` tensor in the compute type.  The gram
    tier's probe pass keeps the residual whole: none of these."""
    from repro_torch.dist import sharding

    splits = [sharding.tp_split(cfg, p, plan, seq) for p in range(cfg.period)]
    n_sub = n_split = n_last = 0
    for layer in range(cfg.num_layers):
        p = layer % cfg.period
        subs = [bool(splits[p].ssm if cfg.pattern[p] == "mamba" else splits[p].attn)]
        if cfg.d_ff > 0:
            subs.append(splits[p].ffn is not None)
        n_sub, n_split, n_last = n_sub + len(subs), n_split + sum(subs), n_last + subs[-1]
    again = bool(cfg.remat)
    head = cfg.vocab_size % plan.tp_size == 0
    calls = {"entry_all_gather": n_sub + 1 + again * n_sub,
             "entry_reduce_scatter": n_split + head,
             "exit_reduce_scatter": n_split + again * (n_split - n_last),
             "exit_all_gather": n_split, "slice_all_gather": n_sub - n_split}
    whole = bm * seq * cfg.d_model * torch.empty((), dtype=getattr(
        torch, cfg.compute_dtype)).element_size()
    return {k: (n * micro, n * micro * whole) for k, n in calls.items()}


class ResidualClock:
    """Times the split residual's collectives by kind (``dist.plan.
    _residual``, through which the entries, exits and slices issue theirs)
    between two synchronisations of the card."""

    def __init__(self):
        from repro_torch.dist import plan as plan_mod

        self.mod, self.ms = plan_mod, dict.fromkeys(RESIDUAL_KINDS, 0.0)
        self.inner = inner = plan_mod._residual

        def timed(kind, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(kind, *args)
            torch.cuda.synchronize()
            self.ms[kind] += 1e3 * (time.perf_counter() - t0)
            return out

        plan_mod._residual = timed

    def snapshot(self) -> dict:
        from repro_torch.dist.plan import residual_counts

        counts = residual_counts()
        return {k: {**counts[k], "ms": self.ms[k]} for k in RESIDUAL_KINDS}

    def close(self) -> None:
        self.mod._residual = self.inner


def residual_delta(before: dict, after: dict) -> dict:
    return {k: {m: after[k][m] - before[k][m] for m in after[k]} for k in after}


class RematKept:
    """While active, the storage bytes of every tensor autograd saves
    outside the remat regions whose shape is ``shape``: a checkpointed
    layer's input, the rank's ``(B, S, d/T)`` columns of the residual (a
    ``saved_tensors_hooks`` count, independent of the port's own
    ``transformer.remat_counts``)."""

    def __init__(self, shape):
        self.shape, self.bytes = tuple(shape), []
        self.hooks = torch.autograd.graph.saved_tensors_hooks(self.pack, lambda t: t)

    def pack(self, t):
        if tuple(t.shape) == self.shape:
            self.bytes.append(t.untyped_storage().nbytes())
        return t

    def __enter__(self):
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)


def residual_check(tag: str, cfg, plan, steps: list[dict], micro: list[int], bm: int,
                   seq: int) -> str:
    """Phases 30, 32 and 33: each step's split residual against the
    reckoning (its collectives by kind, calls and bytes; the bytes remat
    keeps a microbatch, one ``(bm, seq, d/T)`` tensor a layer); raises on a
    miss; returns the line that prints a step's kept bytes."""
    t, d = plan.tp_size, cfg.d_model
    layer = bm * seq * (d // t) * torch.empty((), dtype=getattr(
        torch, cfg.compute_dtype)).element_size()
    for i, (st, n) in enumerate(zip(steps, micro)):
        want = residual_reckoning(cfg, plan, n, bm, seq)
        got = {k: (v["calls"], v["bytes"]) for k, v in st["residual"].items()}
        if got != want:
            raise AssertionError(f"{tag} step {i + 1} the residual's collectives {got}, "
                                 f"expected {want}")
        if "kept" in st and st["kept"] != [layer] * (cfg.num_layers * n):
            raise AssertionError(f"{tag} step {i + 1} remat kept {st['kept']}, expected "
                                 f"{cfg.num_layers * n} x {layer} bytes")
    return (f"remat keeps a rank {cfg.num_layers} tensors of ({bm}, {seq}, {d // t}) a "
            f"microbatch, {cfg.num_layers * layer / 1e6:.3f} MB = the reckoning "
            f"({cfg.num_layers} x {bm} x {seq} x {d}/{t} x 2 bytes; the whole residual's "
            f"{t * cfg.num_layers * layer / 1e6:.3f} MB)")


def residual_line(res: dict) -> str:
    return "; ".join(f"{what} {res[k]['calls']} calls, {res[k]['bytes'] / 1e6:.3f} MB, "
                     f"{res[k]['ms']:.1f} ms" for k, what in RESIDUAL_KINDS.items())


def tp_plan_abstract():
    """Phase 30's rung roles on an abstract mesh (the reckoning's)."""
    from repro_torch.dist.plan import ShardingPlan, abstract_mesh

    return ShardingPlan(mesh=abstract_mesh((1, TP_WORLD), ("data", "model")), dp=("data",),
                        fsdp=("data",), tp="model", ep=("data",))


def tp_gram_step(cfg, opt, plan, dev):
    return make_train_step(
        cfg, opt, 1, plan=plan, estimator="gram",
        probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
        probe_specs=lambda p, n: probes.probe_specs(cfg, n, SHARD_SEQ, device=dev))


def tp_gram_batch(i: int) -> dict:
    return TokenStream(YI.vocab_size, seed=5).batch(i, SHARD_MICRO, SHARD_SEQ)


def tp_one_process(path: str, dev: str = "cuda") -> dict:
    """30's reference in the parent: the run on one process with whole
    state, 25a's program on the moment tier (no data-parallel layout), then
    the gram-tier steps; its final parameters to ``path``."""
    cfg = shard_yi_cfg()
    opt = sgd(momentum=0.9)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = StepEngine.for_lm(cfg, opt, micro_batch=SHARD_MICRO, attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    out = train_lm.train(cfg, params, shard_yi_program(), steps=SHARD_STEPS,
                         seq_len=SHARD_SEQ, micro_batch=SHARD_MICRO, engine=engine,
                         log=lambda line: None)
    state, gram = out["state"], tp_gram_step(cfg, opt, None, dev)
    rec = {"loss": [r["loss"] for r in out["records"]],
           "batch": [r["batch"] for r in out["records"]],
           "buckets": list(engine.stats.buckets),
           "ms": [1e3 * r["seconds"] for r in out["records"]], "gram_loss": [], "gram_ms": []}
    for i in range(TP_GRAM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = gram(state, tp_gram_batch(i), TRAIN_LR)
        rec["gram_loss"].append(float(metrics["loss"]))
        rec["gram_ms"].append(1e3 * (time.perf_counter() - t0))
    rec["sq_norm_sum"] = state.div_state.sq_norm_sum.item()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save({n: p.detach().cpu() for n, p in params.named_parameters()}, path)
    del out, state, params, engine
    free()
    return rec


def psgn_expected(widths: dict, b: int, s: int, dtype) -> dict[str, int]:
    """The psgn launches of ``ops.persample_sq_norm_tree`` over layers of
    ``{name: (Din, Dout)}`` at (B, S): one fused launch per group of two
    or more, else one direct or gram launch per layer."""
    acts = {n: torch.empty((b, s, i), dtype=dtype, device="meta") for n, (i, _) in widths.items()}
    deltas = {n: torch.empty((b, s, o), dtype=dtype, device="meta")
              for n, (_, o) in widths.items()}
    out = {"psgn_direct": 0, "psgn_gram": 0, "psgn_fused": 0}
    for key, names in ops.group_layers(acts, deltas).items():
        if key[0] != "solo" and len(names) >= 2:
            out["psgn_fused"] += 1
        else:
            for n in names:
                out["psgn_" + ops.choose_method(s, *widths[n])] += 1
    return out


def rank_tp(dev, args) -> dict:
    """30 on a rank: Yi-6B on the (data 1, model 2) rung, each block's heads
    and FFN widths split over the ranks: 25a's program on the moment tier,
    then the gram-tier steps; per step its ms, collectives by kind and the
    tensor-parallel all-reduces; the heads the flash wrapper saw and the
    widths the psgn kernels read."""
    from repro_torch.dist.plan import reset_tensor_parallel_counts, tensor_parallel_counts
    from repro_torch.launch.mesh import make_plan, make_production_mesh

    cfg = shard_yi_cfg()
    opt = sgd(momentum=0.9)
    plan = make_plan(make_production_mesh(device=dev, tp=TP_WORLD))
    params = place(tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), plan)
    engine = StepEngine.for_lm(cfg, opt, micro_batch=SHARD_MICRO, attn_impl="pallas",
                               plan=plan)
    clock = CollectiveClock()
    heads, widths = set(), {}
    flash, tree = kattn.flash_attention, ops.persample_sq_norm_tree

    def spy_flash(q, k, v, *a, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return flash(q, k, v, *a, **kw)

    def spy_tree(acts, deltas, *a, **kw):
        widths.update({n: (x.shape[-1], deltas[n].shape[-1]) for n, x in acts.items()})
        return tree(acts, deltas, *a, **kw)

    kattn.flash_attention, ops.persample_sq_norm_tree = spy_flash, spy_tree
    rclock, cols = ResidualClock(), (SHARD_MICRO, SHARD_SEQ, cfg.d_model // TP_WORLD)

    def timed(fn, state, batch, lr, into: list, kept: bool = False):
        before, tp0, vp0 = clock.snapshot(), tensor_parallel_counts(), tf.vocab_parallel_counts()
        r0 = rclock.snapshot()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with RematKept(cols) if kept else contextlib.nullcontext() as saved:
            state, metrics = fn(state, batch, lr)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
        tp1, vp1 = tensor_parallel_counts(), tf.vocab_parallel_counts()
        into.append({"batch": int(next(iter(batch.values())).shape[0]), "loss": loss,
                     "ms": 1e3 * (time.perf_counter() - t1),
                     "coll": clock_delta(before, clock.snapshot()),
                     "tp": {k: tp1[k] - tp0[k] for k in tp1},
                     "vp": {k: {m: vp1[k][m] - vp0[k][m] for m in vp1[k]} for k in vp1},
                     "residual": residual_delta(r0, rclock.snapshot()),
                     **({"kept": saved.bytes} if kept else {})})
        return state, metrics

    steps, inner = [], engine.step
    engine.step = lambda state, batch, lr: timed(inner, state, batch, lr, steps, kept=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tf.reset_tp_counts()
    reset_tensor_parallel_counts()
    try:
        out = train_lm.train(cfg, params, shard_yi_program(), steps=SHARD_STEPS,
                             seq_len=SHARD_SEQ, micro_batch=SHARD_MICRO, engine=engine,
                             plan=plan, log=lambda line: None)
        torch.cuda.synchronize()
        rec = {"steps": steps, "num_micro": [r["num_micro"] for r in out["records"]],
               "moment_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "buckets": list(engine.stats.buckets), "launches": kernels.launch_counts(),
               "routes": kernels.route_counts(), "tp_counts": tf.tp_counts(),
               "heads": sorted(heads), "plan": plan_of(cfg, torch.bfloat16)}
        state = out["state"]
        gram, rec["gram"] = tp_gram_step(cfg, opt, plan, dev), []
        kernels.reset_launch_counts()
        heads.clear()
        for i in range(TP_GRAM_STEPS):
            state, _ = timed(gram, state, tp_gram_batch(i), TRAIN_LR, rec["gram"])
        torch.cuda.synchronize()
        rec.update(gram_launches=kernels.launch_counts(), gram_routes=kernels.route_counts(),
                   gram_heads=sorted(heads), widths=widths,
                   sq_norm_sum=state.div_state.sq_norm_sum.item(),
                   bytes=state_bytes(state),
                   params=sum(p.numel() for p in state.params.parameters()),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        whole = torch.load(args["whole"]) if dist.get_rank() == 0 else None
        gap = 0.0
        for n, w in whole_params(state.params).items():
            if whole is not None:
                gap = max(gap, (w.float().cpu() - whole[n].float()).abs().max().item())
        rec["param_gap"] = gap
    finally:
        kattn.flash_attention, ops.persample_sq_norm_tree = flash, tree
        rclock.close()
        clock.close()
    return rec


def tp_phase() -> dict[str, dict]:
    """Phase 30, from the runs made within phase 25 (its one-process run in
    the parent, its ranks in phase 25's gloo world); returns the launch
    counts of its paths, summed over the ranks."""
    phase(f"30. tensor-parallel training on {TP_WORLD} gloo ranks sharing the card: Yi-6B "
          f"widths at {SHARD_LAYERS} of 32 layers on a (data 1, model {TP_WORLD}) rung, each "
          f"block's heads and FFN widths, the embedding's d and the head's V split over the "
          f"ranks (Megatron-style, the cross-entropy vocab-parallel), the residual stream by "
          f"d_model columns, d/{TP_WORLD} a rank between sublayers (run within phase 25's "
          f"gloo world)")
    cfg = shard_yi_cfg()
    layers, t = cfg.num_layers, TP_WORLD
    mine, whole_bytes, mine_params = reckoned_state_bytes(cfg, t, tp_plan_abstract())
    one, res = PHASE30["one"], dict(sorted(PHASE30["res"].items()))
    print(f"  one process, whole state: losses {[round(x, 5) for x in one['loss']]}, "
          f"batches {one['batch']}, step ms {[round(x, 1) for x in one['ms']]}; gram "
          f"tier {[round(x, 5) for x in one['gram_loss']]}, "
          f"{[round(x, 1) for x in one['gram_ms']]} ms; sq_norm_sum "
          f"{one['sq_norm_sum']:.6e}; peak {one['peak_gib']:.2f} GiB")
    hq, hk = cfg.num_heads // t, cfg.num_kv_heads // t
    hd, d, ff = cfg.resolved_head_dim, cfg.d_model, cfg.d_ff // t
    want_widths = {"q": (d, hq * hd), "k": (d, hk * hd), "v": (d, hk * hd), "o": (hq * hd, d),
                   "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    for r, y in res.items():
        tag = f"[gloo, world {t}, rank {r}]"
        if y["bytes"] != mine or y["params"] != mine_params:
            raise AssertionError(f"{tag} holds {y['bytes']} bytes ({y['params']} parameters), "
                                 f"reckoned {mine} ({mine_params})")
        losses = [st["loss"] for st in y["steps"]] + [g["loss"] for g in y["gram"]]
        want_losses = one["loss"] + one["gram_loss"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        sq = abs(y["sq_norm_sum"] - one["sq_norm_sum"]) / one["sq_norm_sum"]
        batches = [st["batch"] for st in y["steps"]]
        if batches != one["batch"] or y["buckets"] != one["buckets"] \
                or rel > SHARD_LOSS_RTOL or sq > SHARD_LOSS_RTOL:
            raise AssertionError(f"{tag} batches {batches} buckets {y['buckets']} losses "
                                 f"{losses} sq_norm_sum {y['sq_norm_sum']} against {one}")
        if r == 0 and y["param_gap"] > SHARD_PARAM_ATOL:
            raise AssertionError(f"{tag} gathered parameters {y['param_gap']:.3e} from the "
                                 f"one-process run's (tol {SHARD_PARAM_ATOL})")
        n_micro = sum(y["num_micro"])
        want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
                "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
        if y["launches"] != want or [tuple(h) for h in y["heads"]] != [(hq, hk)]:
            raise AssertionError(f"{tag} launches {y['launches']}, expected {want}; heads "
                                 f"{y['heads']}, expected {[(hq, hk)]}")
        attn_routes(y["launches"], y["plan"], what=f"{tag} tensor-parallel Yi",
                    routes=y["routes"])
        split = {"tp_split": {"attn": layers * n_micro, "dense": layers * n_micro,
                              "residual": layers * n_micro, "embed": n_micro,
                              "head": n_micro}, "tp_whole": {}}
        if y["tp_counts"] != split:
            raise AssertionError(f"{tag} tp_counts {y['tp_counts']}, expected {split}")
        # a logsumexp all-gather a microbatch; the split residual takes the
        # embedding's columns as they are and sums the head's dx in its final
        # entry, so only a gram step's probe pass (the residual whole) issues
        # the other two, and one more logsumexp all-gather
        for i, st in enumerate(y["steps"] + y["gram"]):
            n = st["batch"] // SHARD_MICRO if i < len(y["steps"]) else 1
            probe = int(i >= len(y["steps"]))
            want_vp = {"xent_all_gather": n + probe, "input_all_gather": probe,
                       "head_all_reduce": probe}
            if {k: st["vp"][k]["calls"] for k in TP_VOCAB_KINDS} != want_vp:
                raise AssertionError(f"{tag} vocab-parallel collectives {st['vp']}, expected "
                                     f"{want_vp} calls")
        kept_line = residual_check(tag, cfg, tp_plan_abstract(), y["steps"] + y["gram"],
                                   [st["batch"] // SHARD_MICRO for st in y["steps"]]
                                   + [1] * len(y["gram"]), SHARD_MICRO, SHARD_SEQ)
        got_widths = {n.rsplit(".", 1)[1]: tuple(w) for n, w in y["widths"].items()}
        if got_widths != want_widths:
            raise AssertionError(f"{tag} psgn widths {y['widths']}, expected {want_widths}")
        psgn_want = psgn_expected(y["widths"], SHARD_MICRO, SHARD_SEQ, torch.bfloat16)
        gram_want = {"chunk_attention": 2 * layers, "paged_decode_attention": 0,
                     "flash_dq": layers, "flash_dkv": layers, "psgn_split": 0,
                     "quantize_int8": 0, **psgn_want}
        gram_want = {k: v * TP_GRAM_STEPS for k, v in gram_want.items()}
        got_gram = {k: y["gram_launches"].get(k, 0) for k in gram_want}
        if got_gram != gram_want or [tuple(h) for h in y["gram_heads"]] != [(hq, hk)]:
            raise AssertionError(f"{tag} gram launches {y['gram_launches']}, expected "
                                 f"{gram_want}; heads {y['gram_heads']}")
        attn_routes(y["gram_launches"], y["plan"], what=f"{tag} tensor-parallel gram",
                    routes=y["gram_routes"])
        if any(v.get("fma", 0) for k, v in y["gram_routes"].items() if k.startswith("psgn")):
            raise AssertionError(f"{tag} psgn routes {y['gram_routes']}: an FMA launch")
        p25 = PHASE25.get("peak_gib", {}).get(r)
        print(f"  {tag} resident state {y['bytes'] / 1e9:.3f} GB = the reckoning "
              f"({100 * y['bytes'] / whole_bytes:.1f}% of the whole {whole_bytes / 1e9:.3f} "
              f"GB), {y['params'] / 1e9:.4f} B parameters; peak {y['peak_gib']:.2f} GiB "
              f"(the moment-tier steps {y['moment_peak_gib']:.2f}; the gram steps' probe pass "
              f"runs the dense attention lane; with the head and the embedding whole on each "
              f"rank "
              f"{TP_WHOLE_VOCAB['peak_gib']:.2f}; phase 25's (data 2) rung at the same cut: "
              + (f"{p25:.2f}" if p25 is not None else "not run") + f"; one process "
              f"{one['peak_gib']:.2f})")
        lo, hi = TP_WHOLE_VOCAB["ms"]
        print(f"    step ms {[round(st['ms'], 1) for st in y['steps']]} (with the head and the "
              f"embedding whole on each rank {lo}-{hi}); vocab-parallel collectives a "
              f"moment-tier step: "
              + "; ".join(f"{what} {y['steps'][0]['vp'][k]['calls']} calls, "
                          f"{y['steps'][0]['vp'][k]['bytes'] / 1e6:.3f} MB"
                          for k, what in TP_VOCAB_KINDS.items()))
        c25 = PHASE25.get("coll", {}).get(r, [])
        for i, st in enumerate(y["steps"] + y["gram"]):
            c = st["coll"]
            coll_ms = sum(c["ms"][n] for n in COLLECTIVES)
            gram_step = i >= len(y["steps"])
            p25_line = ""
            if not gram_step and i < len(c25):
                g25 = c25[i]
                p25_line = (f"; phase 25's step {i + 1} gathered "
                            f"{g25['calls']['all_gather_into_tensor']} calls, "
                            f"{g25['bytes']['all_gather_into_tensor'] / 1e9:.3f} GB")
            head = st["vp"]["head_all_reduce"]
            vp_line = "; ".join(f"{what} {st['vp'][k]['calls']} calls, "
                                f"{st['vp'][k]['bytes'] / 1e6:.3f} MB"
                                for k, what in TP_VOCAB_KINDS.items())
            print(f"    {'gram ' if gram_step else ''}step {i + 1}: batch {st['batch']}, loss "
                  f"{st['loss']:.5f} (one process {want_losses[i]:.5f}), {st['ms']:.1f} ms "
                  f"(one process {(one['ms'] + one['gram_ms'])[i]:.1f}); vocab-parallel: "
                  f"{vp_line}; the split residual: {residual_line(st['residual'])}; the "
                  f"other tp all-reduces {st['tp']['calls'] - head['calls']} calls, "
                  f"{(st['tp']['bytes'] - head['bytes']) / 1e9:.3f} GB; collectives "
                  f"{coll_ms:.1f} ms ({100 * coll_ms / st['ms']:.1f}%): {coll_line(c)}"
                  + p25_line)
        print(f"    losses within {rel:.3e} relative, sq_norm_sum {y['sq_norm_sum']:.6e} "
              f"within {sq:.3e} (tol {SHARD_LOSS_RTOL}), batches and buckets {y['buckets']} "
              f"the one process's"
              + (f", gathered parameters within {y['param_gap']:.3e} (tol {SHARD_PARAM_ATOL})"
                 if r == 0 else "")
              + f"; heads a rank {hq}/{hk} (n_rep {hq // hk}); launches {y['launches']} (= "
              f"{2 * layers}, {layers}, {layers} x {n_micro} microbatches), all three on tc; "
              f"tp_counts {y['tp_counts']}; the residual's collectives every step the "
              f"reckoning's; {kept_line}")
        print(f"    gram tier, {TP_GRAM_STEPS} steps: psgn widths (Din, Dout) "
              f"{dict(sorted(got_widths.items()))}; launches {got_gram} (= main pass "
              f"{2 * layers}, {layers}, {layers} + {psgn_want} x {TP_GRAM_STEPS}), psgn routes "
              f"{ {k: v for k, v in y['gram_routes'].items() if k.startswith('psgn')} }")
    return {"tensor-parallel training (ranks)": {
                k: sum(res[r]["launches"][k] for r in res) for k in res[0]["launches"]},
            "tensor-parallel gram steps (ranks)": {
                k: sum(res[r]["gram_launches"][k] for r in res) for k in res[0]["gram_launches"]}}


# ---------------------------------------------------------------------------
# phase 31: tensor-parallel serving on ranks
# ---------------------------------------------------------------------------

# phase 4's model (Yi-6B, all 32 layers), settings and trace on a (data 1,
# model 2) rung of phase 28's 2 gloo ranks
TP_SERVE_WORLD = 2
#: phase 4's top-two logit gap (in bf16 ulps of the top logit) at or below
#: which the tp run's token may differ: the logits are bf16 products, and
#: the tp run rounds the o and FFN products' partial sums apart
TP_SERVE_TIE_ULPS = 4
#: the first tokens' logits: largest gap over phase 4's largest magnitude
#: (bf16 logits, 32 layers, the o and FFN products' partial sums added
#: over 2 ranks in bf16: the largest of 64000 gaps of a few bf16 ulps)
TP_SERVE_LOGIT_RTOL = 1e-1
#: the collectives a tensor-parallel serving step issues
TP_SERVE_KINDS = ("tp all-reduces", "embedding all-gather", "logit all-gather", "tokens",
                  "policy")


def tp_serve_kernel_records(r) -> list[dict]:
    """Rows 1f and 4e: the chunk forward (C 256 over 768 prior tokens) and
    paged decode (B 8, lengths <= 1100) at phase 4's shapes with a tp
    rank's heads, Yi-6B's 32/4 split over 2 ranks: 16 query heads over 2
    KV heads (n_rep 8, hd 128); their launches count phase 31's path."""
    rank = YI.replace(num_heads=YI.num_heads // TP_SERVE_WORLD,
                      num_kv_heads=YI.num_kv_heads // TP_SERVE_WORLD,
                      head_dim=YI.resolved_head_dim)
    path = {"paths": ["tensor-parallel serving (ranks)"]}
    return [chunk_kernel_record(r, rank, "a tp rank's serving shape (16/2 heads)",
                                name="chunk_attention (tp rank: 16/2 heads, serving)",
                                counter="chunk_attention", **path),
            decode_kernel_record(r, rank, "a tp rank's serving shape (16/2 heads)",
                                 name="paged_decode_attention (tp rank: 16/2 heads)",
                                 counter="paged_decode_attention", **path)]


class KernelSpy:
    """``kernels/attention.py`` as ``models/transformer.py`` sees it while
    installed (``tf.kernels_attn``): the paged-decode and chunk wrappers
    record the heads ``(query, KV)`` of each call, then run as they are
    (the module's own names stay theirs: each counts its launches under
    its name)."""

    def __init__(self):
        self.heads = set()

    def __getattr__(self, name):
        return getattr(kattn, name)

    def paged_decode_attention(self, q, k, *a, **kw):
        self.heads.add((q.shape[2], k.shape[-2]))
        return kattn.paged_decode_attention(q, k, *a, **kw)

    def chunk_attention(self, q, k, *a, **kw):
        self.heads.add((q.shape[2], k.shape[-2]))
        return kattn.chunk_attention(q, k, *a, **kw)


def rank_tp_serve(dev, args) -> dict:
    """31 on a rank: Yi-6B (32 layers) on the (data 1, model 2) rung under
    ``use_plan``, phase 4's engine settings and trace; per step its seconds
    and the collectives by kind; the heads the kernels saw, the launches,
    the pool's bytes, the parameters held, the first logits and tokens."""
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import (reset_tensor_parallel_counts, tensor_parallel_counts,
                                       use_plan)
    from repro_torch.launch.mesh import make_plan, make_production_mesh
    from repro_torch.serve import engine as engine_mod

    cfg = YI
    plan = make_plan(make_production_mesh(device=dev, tp=TP_SERVE_WORLD))
    torch.cuda.reset_peak_memory_stats(dev)
    with use_plan(plan):  # the engine keeps this rank's shards of the whole model
        engine = ServeEngine(cfg, tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                                 dev), **SLICE_KW)
    free()
    init_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    samples: dict = {}
    record_samples(engine, samples)
    clock = ServeClock()
    parts = PartClock(clock, TP_SERVE_KINDS[1:])
    spy, calls = KernelSpy(), {"decode": 0, "chunk": 0}
    inner = (tf.decode_step, tf.prefill_chunk, tf._model_input, tf._head,
             engine_mod.broadcast_object)

    def counted(kind, fn):
        def call(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return call

    tf.kernels_attn = spy
    tf.decode_step, tf.prefill_chunk = counted("decode", inner[0]), counted("chunk", inner[1])
    tf._model_input = parts.wrap("embedding all-gather", inner[2])
    tf._head = parts.wrap("logit all-gather", inner[3])
    engine._agree = parts.wrap("tokens", engine._agree)
    engine_mod.broadcast_object = parts.wrap("policy", inner[4], wall=True)
    steps = []

    def step():
        c0, s0 = engine.stats.prefill_chunks, engine.stats.steps
        before, p0, tp0 = clock.snapshot(), parts.snapshot(), tensor_parallel_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        more = engine.step()
        torch.cuda.synchronize()
        after, p1, tp1 = clock.snapshot(), parts.snapshot(), tensor_parallel_counts()
        kinds = {k: {m: p1[k][m] - p0[k][m] for m in ("ms", "bytes", "calls")}
                 for k in TP_SERVE_KINDS[1:]}
        ar = {m: after[m]["all_reduce"] - before[m]["all_reduce"] for m in ("ms", "bytes")}
        # the all-reduces outside the tokens' agreement: the tp ones
        kinds["tp all-reduces"] = {"ms": ar["ms"] - kinds["tokens"]["ms"],
                                   "bytes": tp1["bytes"] - tp0["bytes"],
                                   "calls": tp1["calls"] - tp0["calls"]}
        steps.append({"s": time.perf_counter() - t, "chunks": engine.stats.prefill_chunks - c0,
                      "decoded": engine.stats.steps - s0, "coll": kinds,
                      "coll_ms": sum(after["ms"][n] - before["ms"][n] for n in ServeClock.ARG)})
        return more

    reqs = slice_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    tf.reset_tp_counts()
    reset_tensor_parallel_counts()
    t0 = time.perf_counter()
    try:
        rids = slice_trace(engine, reqs, step)
        torch.cuda.synchronize()
        engine.pool.check()
    finally:
        tf.kernels_attn = kattn
        (tf.decode_step, tf.prefill_chunk, tf._model_input, tf._head,
         engine_mod.broadcast_object) = inner
        clock.close()
    layout = sharding.layout_of(engine.params)
    out = {"tokens": [engine.result(rid).tokens.tolist() for rid in rids],
           "first": samples["first"], "steps": steps, "calls": calls,
           "heads": sorted(spy.heads),
           "launches": kernels.launch_counts(), "routes": kernels.route_counts(),
           "tp_counts": tf.tp_counts(), "pool_bytes": pool_bytes(engine),
           "kv_heads": engine._kv_heads, "tp_rank": engine._tp_rank,
           "params": sum(p.numel() for p in engine.params.parameters()),
           "reckoned": layout.numel(), "wall_s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "init_peak_gib": init_peak,
           "stats": engine.stats.as_dict(), "plan": plan_of(cfg, torch.bfloat16)}
    del engine
    free()
    return out


def tp_serve_phase(phase28: dict) -> dict[str, dict]:
    """Phase 31, from its ranks' run within phase 28's gloo world, against
    phase 4's one-process run; ``phase28`` the medians phase 28's rank
    ladder decoded at.  Returns the launch counts of its path, summed over
    the ranks."""
    phase(f"31. tensor-parallel serving on {TP_SERVE_WORLD} gloo ranks sharing the card: "
          f"Yi-6B, all {YI.num_layers} layers, bf16, on a (data 1, model {TP_SERVE_WORLD}) "
          f"rung, phase 4's engine settings and trace; each rank's heads, FFN columns, "
          f"embedding columns, vocabulary and KV pool (run within phase 28's gloo world)")
    cfg, t = YI, TP_SERVE_WORLD
    want, res = PHASE31["want"], dict(sorted(PHASE31["res"].items()))
    _, _, mine_params = reckoned_state_bytes(cfg, t, tp_plan_abstract())
    hq, hk = cfg.num_heads // t, cfg.num_kv_heads // t
    layers = cfg.num_layers
    gaps = want["gaps"]
    plens = [padded_prompt_len(len(q.prompt), SLICE_KW["prompt_granule"])
             for q in slice_requests(cfg.vocab_size)]
    failed = []
    for r, y in res.items():
        tag = f"[gloo, world {t}, rank {r}]"
        if y["params"] != y["reckoned"] or y["params"] != mine_params:
            raise AssertionError(f"{tag} holds {y['params']} parameters, reckoned "
                                 f"{y['reckoned']} (the specs: {mine_params})")
        if 2 * y["pool_bytes"] != want["pool_bytes"] or y["kv_heads"] != hk:
            raise AssertionError(f"{tag} pool {y['pool_bytes']} bytes at {y['kv_heads']} KV "
                                 f"heads; phase 4's {want['pool_bytes']}")
        n_dec, n_chunk = y["calls"]["decode"], y["calls"]["chunk"]
        want_counts = {"chunk_attention": layers * n_chunk,
                       "paged_decode_attention": layers * n_dec,
                       "flash_dq": 0, "flash_dkv": 0, **NO_PSGN}
        if y["launches"] != want_counts or 0 in (n_dec, n_chunk) \
                or n_dec != y["stats"]["steps"] or n_chunk != y["stats"]["prefill_chunks"]:
            raise AssertionError(f"{tag} launches {y['launches']}, expected {want_counts} "
                                 f"({n_dec} decode steps, {n_chunk} chunks; stats "
                                 f"{y['stats']['steps']}, {y['stats']['prefill_chunks']})")
        if [tuple(h) for h in y["heads"]] != [(hq, hk)]:
            raise AssertionError(f"{tag} the kernels saw heads {y['heads']}, expected "
                                 f"{[(hq, hk)]}")
        attn_routes(y["launches"], y["plan"], what=f"{tag} tensor-parallel serving",
                    routes=y["routes"])
        split = {"attn": layers * (n_dec + n_chunk), "dense": layers * (n_dec + n_chunk),
                 "embed": n_dec + n_chunk, "head": n_dec + n_chunk}
        if y["tp_counts"] != {"tp_split": split, "tp_whole": {}}:
            raise AssertionError(f"{tag} tp_counts {y['tp_counts']}, expected {split} split")
        # tokens: phase 4's up to its first near-tie (a top-two gap of at most
        # TP_SERVE_TIE_ULPS bf16 ulps); each request's first differing token
        ties, bad = [], []
        for i, (got, ref_toks) in enumerate(zip(y["tokens"], want["tokens"])):
            cut = next((j for j in range(len(ref_toks))
                        if gaps[(i, plens[i] + j)][1] <= TP_SERVE_TIE_ULPS), len(ref_toks))
            diff = next((j for j in range(len(ref_toks)) if got[j] != ref_toks[j]), None)
            if diff is not None:
                top, ulps = gaps[(i, plens[i] + diff)]
                (bad if diff < cut else ties).append((i, diff, round(top, 4), round(ulps, 2)))
            if len(got) != len(ref_toks):
                bad.append((i, len(got)))
        if set(y["first"]) != set(want["first"]):
            raise AssertionError(f"{tag} prefilled requests {sorted(y['first'])}, phase 4 "
                                 f"{sorted(want['first'])}")
        rel = max(float(np.abs(y["first"][i] - want["first"][i]).max()
                        / np.abs(want["first"][i]).max()) for i in want["first"])
        rms = max(float(np.sqrt(np.mean((y["first"][i] - want["first"][i]) ** 2)
                                / np.mean(want["first"][i] ** 2))) for i in want["first"])
        big = max(float(np.abs(y["first"][i] - want["first"][i]).max()) for i in want["first"])
        top_abs = max(float(np.abs(want["first"][i]).max()) for i in want["first"])
        d_ms, c_ms, nd, nc = step_medians([(st["s"], st["chunks"], st["decoded"])
                                           for st in y["steps"]])
        print(f"  {tag} {y['params'] / 1e9:.4f} B parameters held = the reckoning "
              f"({2 * y['params'] / 1e9:.3f} GB bf16; peak {y['init_peak_gib']:.2f} GiB while "
              f"the whole model is drawn, then sharded); pool {y['pool_bytes'] / 2**30:.3f} GiB "
              f"= half of phase 4's {want['pool_bytes'] / 2**30:.3f} ({y['kv_heads']} of "
              f"{cfg.num_kv_heads} KV heads, tp rank {y['tp_rank']}); serving peak "
              f"{y['peak_gib']:.2f} GiB; {y['wall_s']:.1f} s")
        print(f"    tokens: phase 4's but where its top two logits lay within "
              f"{TP_SERVE_TIE_ULPS} bf16 ulps; the first differing token of a request "
              f"(request, token, phase 4's top logit, gap in ulps): near-ties {ties}, "
              f"others {bad}; first logits within {rel:.3e} of their largest magnitude (tol "
              f"{TP_SERVE_LOGIT_RTOL}), RMS gap {rms:.3e} of their RMS, the largest gap "
              f"{big:.4f} against a largest magnitude of {top_abs:.4f}")
        if bad or rel > TP_SERVE_LOGIT_RTOL:  # raised once both ranks have printed
            failed.append(f"{tag} tokens differ from phase 4's before a near-tie: {bad}; "
                          f"first logits {rel:.3e} of their largest magnitude from phase 4's "
                          f"(tol {TP_SERVE_LOGIT_RTOL})")
        print(f"    launches {y['launches']} (= {layers} x {n_chunk} chunks, {layers} x {n_dec} "
              f"decode steps), the kernels at {hq}/{hk} heads (n_rep {hq // hk}); tp_counts "
              f"{y['tp_counts']}")
        print(f"    decode step: median {d_ms:.2f} ms over {nd} decode-only steps (phase 4, "
              f"one process: {want['decode_ms']:.2f}; phase 28's 2-rank rung, 2 layers, "
              f"block gathers: {phase28.get(r, '-')}); prefill chunk: median {c_ms:.2f} ms "
              f"over {nc} (phase 4: {want['chunk_ms']:.2f})")
        dec = [st for st in y["steps"] if st["decoded"] and not st["chunks"]]
        chk = [st for st in y["steps"] if st["chunks"]]
        for label, sts in (("a decode step", dec), ("a step with chunks (and its decode)", chk)):
            if not sts:
                continue
            ms = statistics.median(1e3 * st["s"] for st in sts)
            line = []
            for kind in TP_SERVE_KINDS:
                med = {m: statistics.median(st["coll"][kind][m] for st in sts)
                       for m in ("calls", "bytes", "ms")}
                line.append(f"{kind} {med['calls']:.0f} calls, {med['bytes'] / 1e6:.3f} MB, "
                            f"{med['ms']:.1f} ms")
            coll = statistics.median(st["coll_ms"] for st in sts)
            print(f"    {label} ({len(sts)}, median {ms:.1f} ms; collectives {coll:.1f} ms, "
                  f"{100 * coll / ms:.1f}%): " + "; ".join(line))
    if failed:
        raise AssertionError("\n".join(failed))
    if res[0]["tokens"] != res[1]["tokens"]:
        raise AssertionError("the tp ranks recorded different tokens")
    return {"tensor-parallel serving (ranks)": {
        k: sum(res[r]["launches"][k] for r in res) for k in res[0]["launches"]}}


# ---------------------------------------------------------------------------
# phase 32: context-parallel attention in tensor-parallel training on ranks
# ---------------------------------------------------------------------------

INTERN = get_config("internvl2-1b")
# internvl2-1b at full width on a (data 1, model 4) rung of 4 gloo ranks
# sharing the card: 4 is the smallest T its 14 heads do not divide, and it
# divides H hd = 896, KV hd = 128 and S; 12 of its 24 layers since phase 33
# joined (all 24 before), so that the script keeps inside its limit
CP_WORLD, CP_SEQ, CP_MICRO, CP_STEPS, CP_GRAM_STEPS = 4, 2048, 2, 3, 2
CP_LAYERS = 12
CP_SEED = 7
#: the context-parallel collectives of a forward (``transformer.
#: context_parallel_counts``' kinds)
CP_KINDS = {"q_all_to_all": "q all-to-all", "kv_all_gather": "k/v all-gather",
            "out_all_to_all": "out all-to-all"}


def cp_cfg():
    return INTERN.replace(num_layers=CP_LAYERS, attn_impl="pallas")


def cp_program():
    """32's tick-fired DiveBatch program: batch 2 (one microbatch), a tick
    every 2 steps that may grow it to 4."""
    return train_lm.make_program("divebatch", m0=CP_MICRO, m_max=2 * CP_MICRO, delta=0.5,
                                 granule=CP_MICRO, lr=TRAIN_LR, tick_every=2)


def cp_gram_step(cfg, opt, plan, dev):
    return make_train_step(
        cfg, opt, 1, plan=plan, estimator="gram",
        probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
        probe_specs=lambda p, n: probes.probe_specs(cfg, n, CP_SEQ, device=dev))


def cp_gram_batch(cfg, i: int) -> dict:
    return train_lm.frame_batches(cfg, CP_SEED)(100 + i, CP_MICRO, CP_SEQ)


def cp_plan_abstract():
    """32's rung roles on an abstract mesh (the reckoning's)."""
    from repro_torch.dist.plan import ShardingPlan, abstract_mesh

    return ShardingPlan(mesh=abstract_mesh((1, CP_WORLD), ("data", "model")), dp=("data",),
                        fsdp=("data",), tp="model", ep=("data",))


def cp_one_process(path: str, dev: str = "cuda") -> dict:
    """32's reference in the parent: the run on one process with whole
    state (the moment-tier steps under :func:`cp_program`, then the
    gram-tier steps); its final parameters to ``path``."""
    cfg = cp_cfg()
    opt = sgd(momentum=0.9)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = StepEngine.for_lm(cfg, opt, micro_batch=CP_MICRO, attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    out = train_lm.train(cfg, params, cp_program(), steps=CP_STEPS, seq_len=CP_SEQ,
                         micro_batch=CP_MICRO, engine=engine,
                         batches=train_lm.frame_batches(cfg, CP_SEED), log=lambda line: None)
    state, gram = out["state"], cp_gram_step(cfg, opt, None, dev)
    rec = {"loss": [r["loss"] for r in out["records"]],
           "batch": [r["batch"] for r in out["records"]],
           "buckets": list(engine.stats.buckets),
           "ms": [1e3 * r["seconds"] for r in out["records"]], "gram_loss": [], "gram_ms": []}
    for i in range(CP_GRAM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = gram(state, cp_gram_batch(cfg, i), TRAIN_LR)
        rec["gram_loss"].append(float(metrics["loss"]))
        rec["gram_ms"].append(1e3 * (time.perf_counter() - t0))
    rec["sq_norm_sum"] = state.div_state.sq_norm_sum.item()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save({n: p.detach().cpu() for n, p in params.named_parameters()}, path)
    del out, state, params, engine
    free()
    return rec


def rank_cp(dev, args) -> dict:
    """32 on a rank: internvl2-1b on the (data 1, model 4) rung, attention
    context-parallel (each rank its 512 query rows of every head), the FFN,
    the frontend split, the head whole: the moment-tier steps under
    :func:`cp_program`, then the gram-tier steps; per step its ms, the
    collectives by kind, the context-parallel exchanges and the tensor-
    parallel all-reduces; the heads and rows the flash wrapper saw, the
    widths the psgn kernels read, the launches at the offset form."""
    from repro_torch.dist.plan import reset_tensor_parallel_counts, tensor_parallel_counts
    from repro_torch.launch.mesh import make_plan, make_production_mesh

    cfg = cp_cfg()
    opt = sgd(momentum=0.9)
    plan = make_plan(make_production_mesh(device=dev, tp=CP_WORLD))
    params = place(tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), plan)
    engine = StepEngine.for_lm(cfg, opt, micro_batch=CP_MICRO, attn_impl="pallas",
                               plan=plan)
    clock = CollectiveClock()
    seen, widths = set(), {}
    flash, tree = kattn.flash_attention, ops.persample_sq_norm_tree

    def spy_flash(q, k, v, causal=True, window=None, softcap=None, q_offset=0):
        seen.add((q.shape[2], k.shape[2], q.shape[1], q_offset, k.shape[1]))
        return flash(q, k, v, causal, window, softcap, q_offset)

    def spy_tree(acts, deltas, *a, **kw):
        widths.update({n: (x.shape[-1], deltas[n].shape[-1]) for n, x in acts.items()})
        return tree(acts, deltas, *a, **kw)

    kattn.flash_attention, ops.persample_sq_norm_tree = spy_flash, spy_tree
    rclock, cols = ResidualClock(), (CP_MICRO, CP_SEQ, cfg.d_model // CP_WORLD)

    def timed(fn, state, batch, lr, into: list, kept: bool = False):
        before, tp0, cp0 = clock.snapshot(), tensor_parallel_counts(), tf.context_parallel_counts()
        r0 = rclock.snapshot()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with RematKept(cols) if kept else contextlib.nullcontext() as saved:
            state, metrics = fn(state, batch, lr)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
        tp1, cp1 = tensor_parallel_counts(), tf.context_parallel_counts()
        into.append({"batch": int(next(iter(batch.values())).shape[0]), "loss": loss,
                     "ms": 1e3 * (time.perf_counter() - t1),
                     "coll": clock_delta(before, clock.snapshot()),
                     "tp": {k: tp1[k] - tp0[k] for k in tp1},
                     "cp": {k: {m: cp1[k][m] - cp0[k][m] for m in cp1[k]} for k in cp1},
                     "residual": residual_delta(r0, rclock.snapshot()),
                     **({"kept": saved.bytes} if kept else {})})
        return state, metrics

    steps, inner = [], engine.step
    engine.step = lambda state, batch, lr: timed(inner, state, batch, lr, steps, kept=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tf.reset_tp_counts()
    reset_tensor_parallel_counts()
    try:
        out = train_lm.train(cfg, params, cp_program(), steps=CP_STEPS, seq_len=CP_SEQ,
                             micro_batch=CP_MICRO, engine=engine, plan=plan,
                             batches=train_lm.frame_batches(cfg, CP_SEED),
                             log=lambda line: None)
        torch.cuda.synchronize()
        rec = {"steps": steps, "num_micro": [r["num_micro"] for r in out["records"]],
               "moment_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "buckets": list(engine.stats.buckets), "launches": kernels.launch_counts(),
               "offset": kernels.offset_counts(), "routes": kernels.route_counts(),
               "tp_counts": tf.tp_counts(), "seen": sorted(seen),
               "plan": plan_of(cfg, torch.bfloat16)}
        state = out["state"]
        gram, rec["gram"] = cp_gram_step(cfg, opt, plan, dev), []
        kernels.reset_launch_counts()
        seen.clear()
        for i in range(CP_GRAM_STEPS):
            state, _ = timed(gram, state, cp_gram_batch(cfg, i), TRAIN_LR, rec["gram"])
        torch.cuda.synchronize()
        rec.update(gram_launches=kernels.launch_counts(), gram_offset=kernels.offset_counts(),
                   gram_routes=kernels.route_counts(), gram_seen=sorted(seen), widths=widths,
                   sq_norm_sum=state.div_state.sq_norm_sum.item(),
                   bytes=state_bytes(state),
                   params=sum(p.numel() for p in state.params.parameters()),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        whole = torch.load(args["whole"]) if dist.get_rank() == 0 else None
        gap = 0.0
        for n, w in whole_params(state.params).items():
            if whole is not None:
                gap = max(gap, (w.float().cpu() - whole[n].float()).abs().max().item())
        rec["param_gap"] = gap
    finally:
        kattn.flash_attention, ops.persample_sq_norm_tree = flash, tree
        rclock.close()
        clock.close()
    return rec


RANK_JOBS.update(context_tp=rank_cp)


def cp_offset_inputs(r, *, b, s, t, rank, h, kv, hd, window=None, softcap=None,
                     causal=True) -> dict:
    """Context-parallel rank ``rank`` of ``t`` over a length-``s`` sequence
    in bf16: its ``s/t`` query rows at offset ``s0`` against the keys ``[0,
    s1)`` (causal) or all ``s``, with the card forward's out and lse."""
    st = s // t
    s0, s1 = rank * st, (rank + 1) * st
    sk = s1 if causal else s
    q, dout = (torch.from_numpy(r.standard_normal((b, st, h, hd))).to("cuda", torch.bfloat16)
               for _ in range(2))
    k, v = (torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to("cuda", torch.bfloat16)
            for _ in range(2))
    q_pos = torch.arange(s0, s1, dtype=torch.int32, device="cuda")
    k_pos = torch.arange(sk, dtype=torch.int32, device="cuda")
    ones = torch.ones_like(k_pos)
    out, lse = kattn.chunk_attention_fwd(q, k, v, q_pos, k_pos, ones, window=window,
                                         softcap=softcap, causal=causal)
    return dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse, q_pos=q_pos, k_pos=k_pos,
                k_valid=ones, delta=ref.flash_delta(out, dout), s0=s0, window=window,
                softcap=softcap, causal=causal)


def cp_offset_case(name: str, inp: dict) -> tuple[float, float, float]:
    """The chunk forward, dq and dk/dv at a context-parallel rank's offset
    form against their plain versions: (forward, dq, dk/dv) max abs errors."""
    kw = dict(window=inp["window"], softcap=inp["softcap"], causal=inp["causal"])
    fwd = (inp["q"], inp["k"], inp["v"], inp["q_pos"], inp["k_pos"], inp["k_valid"])
    want, want_lse = ref.attention_ref_lse(*fwd, **kw)
    err_fwd = check(name + " forward", inp["out"], want, torch.bfloat16)
    check(name + " lse", inp["lse"], want_lse, torch.bfloat16)
    args = (inp["q"], inp["k"], inp["v"], inp["dout"], inp["lse"], inp["delta"])
    dq = kattn.flash_dq(*args, q_offset=inp["s0"], **kw)
    dk, dv = kattn.flash_dkv(*args, q_offset=inp["s0"], **kw)
    torch.cuda.synchronize()
    g = ref.flash_grads_ref(inp["q"], inp["k"], inp["v"], inp["lse"], inp["delta"],
                            inp["dout"], q_offset=inp["s0"], **kw)
    tol = FLASH_TOL[torch.bfloat16]
    err_dq = check(name + " dq", dq, g[0], torch.bfloat16, tol=tol)
    err_dkv = max(check(name + " dk", dk, g[1], torch.bfloat16, tol=tol),
                  check(name + " dv", dv, g[2], torch.bfloat16, tol=tol))
    plan = kattn.attention_plan(torch.bfloat16, inp["q"].shape[-1], inp["causal"])
    print(f"  {name} [forward {plan['chunk_attention']}, dq {plan['flash_dq']}, dk/dv "
          f"{plan['flash_dkv']}]: max abs err forward {err_fwd:.3e} (tol "
          f"{TOL[torch.bfloat16]}), dq {err_dq:.3e}, dk/dv {err_dkv:.3e} (atol {tol[0]})")
    return err_fwd, err_dq, err_dkv


def cp_attention_pairs(inp: dict) -> int:
    """The (row, key) pairs the mask lets through, over every (b, h)."""
    q_pos, k_pos = inp["q_pos"].long(), inp["k_pos"].long()
    rel = q_pos[:, None] - k_pos[None, :]
    ok = torch.ones_like(rel, dtype=torch.bool)
    if inp["causal"]:
        ok &= rel >= 0
    if inp["window"] is not None:
        ok &= rel < inp["window"]
    b, _, h, _ = inp["q"].shape
    return b * h * int(ok.sum())


def cp_kernel_phase() -> list[dict]:
    """Rows 1-3 at the offset form on the card, after phase 32's ranks:
    each rank's piece of phase 32's attention (B 2, S 2048, 14/2 heads of
    hd 64, causal) held against the plain versions and its forward and
    backward timed (the causal imbalance of contiguous rows); the last
    rank's, the heaviest, timed as the kernels' records beside SDPA with an
    explicit boolean mask; qwen2-7b's piece at T 16 (28/4 heads of hd 128),
    a non-causal piece (hd 80) and a windowed, softcapped one (hd 128)
    held too."""
    r = np.random.default_rng(32)
    h, kv, hd = INTERN.num_heads, INTERN.num_kv_heads, INTERN.resolved_head_dim
    shape = dict(b=CP_MICRO, s=CP_SEQ, t=CP_WORLD, h=h, kv=kv, hd=hd)
    alone_ms, host_ms = [], []
    for rank in range(CP_WORLD):
        inp = cp_offset_inputs(r, rank=rank, **shape)
        cp_offset_case(f"internvl2-1b piece of rank {rank} (B {CP_MICRO}, "
                       f"{CP_SEQ // CP_WORLD} rows at offset {inp['s0']}, "
                       f"{inp['k'].shape[1]} keys, {h}/{kv} heads)", inp)
        q, k, v, dout, lse, delta = (inp[n] for n in ("q", "k", "v", "dout", "lse", "delta"))
        s0, fwd = inp["s0"], (q, k, v, inp["q_pos"], inp["k_pos"], inp["k_valid"])
        # the card's time alone for the three kernels, and the autograd
        # function's forward and backward host-timed (the host's queueing in)
        alone_ms.append(
            timed_ms(lambda: kattn.chunk_attention_fwd(*fwd), spin=True)
            + timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta, q_offset=s0),
                       spin=True)
            + timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta, q_offset=s0),
                       spin=True))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def fwd_bwd():
            out = kattn.flash_attention(*leaves, q_offset=s0)
            torch.autograd.grad(out, leaves, dout)

        host_ms.append(timed_ms(fwd_bwd))
    tiles = [2 * t + 1 for t in range(CP_WORLD)]
    print(f"  each rank's attention of one layer, forward, dq and dk/dv on the card alone "
          f"(through autograd, host-timed): "
          + ", ".join(f"rank {t} {a:.4f} ms ({b:.4f}; {tiles[t]}/{CP_WORLD ** 2} of the "
                      f"score tiles)" for t, (a, b) in enumerate(zip(alone_ms, host_ms)))
          + f"; the last over the first {alone_ms[-1] / alone_ms[0]:.2f}x alone "
          f"({host_ms[-1] / host_ms[0]:.2f}x host-timed)")
    qwen = get_config("qwen2-7b")
    cp_offset_case("qwen2-7b piece of rank 15 of 16 (B 1, 256 rows at offset 3840, 4096 "
                   "keys, 28/4 heads of hd 128)",
                   cp_offset_inputs(r, b=1, s=4096, t=16, rank=15, h=qwen.num_heads,
                                    kv=qwen.num_kv_heads, hd=qwen.resolved_head_dim))
    cp_offset_case("non-causal piece (B 2, 256 rows at offset 512, 1024 keys, 16/4 heads of "
                   "hd 80)",
                   cp_offset_inputs(r, b=2, s=1024, t=4, rank=2, h=16, kv=4, hd=80,
                                    causal=False))
    cp_offset_case("windowed piece (B 1, 1024 rows at offset 3072, 4096 keys, window 1500, "
                   "softcap 50, 8/4 heads of hd 128)",
                   cp_offset_inputs(r, b=1, s=4096, t=4, rank=3, h=8, kv=4, hd=128,
                                    window=1500, softcap=50.0))
    # the records: the last rank's piece of phase 32
    inp = cp_offset_inputs(r, rank=CP_WORLD - 1, **shape)
    err_fwd, err_dq, err_dkv = cp_offset_case("internvl2-1b last rank (records)", inp)
    q, k, v, dout, lse, delta = (inp[n] for n in ("q", "k", "v", "dout", "lse", "delta"))
    fwd = (q, k, v, inp["q_pos"], inp["k_pos"], inp["k_valid"])
    s0 = inp["s0"]
    fwd_ms = timed_ms(lambda: kattn.chunk_attention_fwd(*fwd))
    fwd_dev = timed_ms(lambda: kattn.chunk_attention_fwd(*fwd), spin=True)
    dq_ms = timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta, q_offset=s0))
    dq_dev = timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta, q_offset=s0),
                      spin=True)
    dkv_ms = timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta, q_offset=s0))
    dkv_dev = timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta, q_offset=s0),
                       spin=True)
    plain_fwd = timed_ms(lambda: ref.attention_ref_lse(*fwd))
    plain_bwd = timed_ms(lambda: ref.flash_grads_ref(q, k, v, lse, delta, dout, q_offset=s0))
    # library yardstick: SDPA with an explicit boolean mask (Sq != Sk)
    mask = inp["q_pos"].long()[:, None] >= inp["k_pos"].long()[None, :]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        sdpa_fwd = timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    gt = dout.transpose(1, 2)
    sdpa_bwd = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    pairs = cp_attention_pairs(inp)
    b, st = q.shape[:2]
    fwd_bound, fwd_by = bound(nbytes(q, k, v, q), 4 * hd * pairs)
    read = nbytes(q, k, v, dout, lse, delta)
    dq_bound, dq_by = bound(read + b * st * h * hd * 4, 3 * 2 * hd * pairs)
    dkv_bound, dkv_by = bound(read + 2 * nbytes(k) * 2, 4 * 2 * hd * pairs)
    plan = kattn.attention_plan(torch.bfloat16, hd)
    where = (f"context-parallel rank {CP_WORLD - 1} of {CP_WORLD}: {st} rows at offset {s0}, "
             f"{k.shape[1]} keys, {h}/{kv} heads, B {b}")
    for label, ms, dev_ms, bnd, by, lib in (
            ("chunk_attention", fwd_ms, fwd_dev, fwd_bound, fwd_by, sdpa_fwd),
            ("flash_dq", dq_ms, dq_dev, dq_bound, dq_by, sdpa_bwd),
            ("flash_dkv", dkv_ms, dkv_dev, dkv_bound, dkv_by, sdpa_bwd)):
        print(f"  {label} [{plan[label]}] at the offset form ({where}): {ms:.4f} ms "
              f"({dev_ms:.4f} on the card alone); bound {bnd:.4f} ms by {by}, "
              f"{100 * bnd / ms:.1f}% of it; library {lib:.4f} ms (SDPA "
              f"{'forward' if label == 'chunk_attention' else 'backward'}, boolean mask)")
    del out, qt, kt, vt
    tc = {n: "_tc" if plan[n] == "tc" else "" for n in ROUTED_ATTENTION}
    paths = ["context-parallel training (ranks)", "context-parallel gram steps (ranks)"]
    common = {"route": "cuda", "paths": paths}
    return [
        {"name": f"chunk_attention ({where})", "counter": "chunk_attention@offset",
         "source": f"src/repro_torch/kernels/csrc/chunk_attention{tc['chunk_attention']}.cu",
         "replaces": "src/repro/kernels/attention.py:92", "max_abs_err": err_fwd,
         "ms": fwd_ms, "device_ms": fwd_dev, "plain_ms": plain_fwd, "bound_ms": fwd_bound,
         "bound_by": fwd_by, "library_ms": sdpa_fwd, **common},
        {"name": f"flash_dq ({where})", "counter": "flash_dq@offset",
         "source": f"src/repro_torch/kernels/csrc/flash_dq{tc['flash_dq']}.cu",
         "replaces": "src/repro/kernels/attention.py:218", "max_abs_err": err_dq,
         "ms": dq_ms, "device_ms": dq_dev, "plain_ms": plain_bwd, "bound_ms": dq_bound,
         "bound_by": dq_by, "library_ms": sdpa_bwd, **common},
        {"name": f"flash_dkv ({where})", "counter": "flash_dkv@offset",
         "source": f"src/repro_torch/kernels/csrc/flash_dkv{tc['flash_dkv']}.cu",
         "replaces": "src/repro/kernels/attention.py:245", "max_abs_err": err_dkv,
         "ms": dkv_ms, "device_ms": dkv_dev, "plain_ms": plain_bwd, "bound_ms": dkv_bound,
         "bound_by": dkv_by, "library_ms": sdpa_bwd, **common},
    ]


def cp_phase() -> tuple[dict[str, dict], list[dict]]:
    """Phase 32: its one-process run in the parent, its 4 ranks in a gloo
    world of their own, then rows 1-3 at the offset form on the card;
    returns the launch counts of its paths (summed over the ranks, with
    the offset form's as ``<kernel>@offset``) and the records."""
    cfg = cp_cfg()
    layers, t = cfg.num_layers, CP_WORLD
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    st = CP_SEQ // t
    phase(f"32. context-parallel attention in tensor-parallel training on {t} gloo ranks "
          f"sharing the card: internvl2-1b at full width and {layers} of {INTERN.num_layers} "
          f"layers on a (data 1, model {t}) rung, its {h}/{kv} heads (which {t} does not "
          f"divide) over each rank's {st} query rows, k/v gathered whole, the FFN and the "
          f"frontend split, the residual stream by d_model columns ({d // t} a rank), the "
          f"head whole (V {cfg.vocab_size})")
    t_phase = time.perf_counter()
    mine, whole_bytes, mine_params = reckoned_state_bytes(cfg, t, cp_plan_abstract())
    root = ckpt_root("context")
    try:
        path = os.path.join(root, "intern_whole.pt")
        one = cp_one_process(path)
        t0 = time.perf_counter()
        res = dict(sorted(spawn_ranks("context_tp", "gloo", t, {"whole": path}).items()))
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  one process, whole state: losses {[round(x, 5) for x in one['loss']]}, "
          f"batches {one['batch']}, step ms {[round(x, 1) for x in one['ms']]}; gram "
          f"tier {[round(x, 5) for x in one['gram_loss']]}, "
          f"{[round(x, 1) for x in one['gram_ms']]} ms; sq_norm_sum "
          f"{one['sq_norm_sum']:.6e}; peak {one['peak_gib']:.2f} GiB")
    ff = cfg.d_ff // t
    want_widths = {"q": (d, h * hd // t), "k": (d, kv * hd // t), "v": (d, kv * hd // t),
                   "o": (h * hd // t, d), "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    for rk, y in res.items():
        tag = f"[gloo, world {t}, rank {rk}]"
        s0, s1 = rk * st, (rk + 1) * st
        if y["bytes"] != mine or y["params"] != mine_params:
            raise AssertionError(f"{tag} holds {y['bytes']} bytes ({y['params']} parameters), "
                                 f"reckoned {mine} ({mine_params})")
        losses = [x["loss"] for x in y["steps"]] + [g["loss"] for g in y["gram"]]
        want_losses = one["loss"] + one["gram_loss"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        sq = abs(y["sq_norm_sum"] - one["sq_norm_sum"]) / one["sq_norm_sum"]
        batches = [x["batch"] for x in y["steps"]]
        if batches != one["batch"] or y["buckets"] != one["buckets"] \
                or rel > SHARD_LOSS_RTOL or sq > SHARD_LOSS_RTOL:
            raise AssertionError(f"{tag} batches {batches} buckets {y['buckets']} losses "
                                 f"{losses} sq_norm_sum {y['sq_norm_sum']} against {one}")
        if rk == 0 and y["param_gap"] > SHARD_PARAM_ATOL:
            raise AssertionError(f"{tag} gathered parameters {y['param_gap']:.3e} from the "
                                 f"one-process run's (tol {SHARD_PARAM_ATOL})")
        n_micro = sum(y["num_micro"])
        want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
                "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
        seen = [(h, kv, st, s0, s1)]
        offset = {k: want[k] if rk else 0 for k in ROUTED_ATTENTION}
        if y["launches"] != want or [tuple(x) for x in y["seen"]] != seen \
                or y["offset"] != offset:
            raise AssertionError(f"{tag} launches {y['launches']} (at the offset form "
                                 f"{y['offset']}), expected {want} ({offset}); the flash "
                                 f"wrapper saw {y['seen']}, expected {seen}")
        attn_routes(y["launches"], y["plan"], what=f"{tag} context-parallel internvl2",
                    routes=y["routes"])
        split = {"tp_split": {"attn_context": layers * n_micro, "dense": layers * n_micro,
                              "residual": layers * n_micro, "frontend": n_micro},
                 "tp_whole": {"head": n_micro}}
        if y["tp_counts"] != split:
            raise AssertionError(f"{tag} tp_counts {y['tp_counts']}, expected {split}")
        kept_line = residual_check(tag, cfg, cp_plan_abstract(), y["steps"] + y["gram"],
                                   [x["batch"] // CP_MICRO for x in y["steps"]]
                                   + [1] * len(y["gram"]), CP_MICRO, CP_SEQ)
        # a forward and its remat recompute a layer a microbatch; the gram
        # steps' probe pass (no remat) once more
        for i, x in enumerate(y["steps"] + y["gram"]):
            gram_step = i >= len(y["steps"])
            n = (2 * layers * x["batch"] // CP_MICRO) + (layers if gram_step else 0)
            if any(x["cp"][k]["calls"] != n for k in CP_KINDS):
                raise AssertionError(f"{tag} step {i + 1} context-parallel collectives "
                                     f"{x['cp']}, expected {n} calls of each")
        got_widths = {n.rsplit(".", 1)[1]: tuple(w) for n, w in y["widths"].items()}
        if got_widths != want_widths:
            raise AssertionError(f"{tag} psgn widths {y['widths']}, expected {want_widths}")
        psgn_want = psgn_expected(y["widths"], CP_MICRO, CP_SEQ, torch.bfloat16)
        gram_want = {"chunk_attention": 2 * layers, "paged_decode_attention": 0,
                     "flash_dq": layers, "flash_dkv": layers, "psgn_split": 0,
                     "quantize_int8": 0, **psgn_want}
        gram_want = {k: v * CP_GRAM_STEPS for k, v in gram_want.items()}
        got_gram = {k: y["gram_launches"].get(k, 0) for k in gram_want}
        if got_gram != gram_want or [tuple(x) for x in y["gram_seen"]] != seen:
            raise AssertionError(f"{tag} gram launches {y['gram_launches']}, expected "
                                 f"{gram_want}; the flash wrapper saw {y['gram_seen']}")
        attn_routes(y["gram_launches"], y["plan"], what=f"{tag} context-parallel gram",
                    routes=y["gram_routes"])
        if any(v.get("fma", 0) for k, v in y["gram_routes"].items() if k.startswith("psgn")):
            raise AssertionError(f"{tag} psgn routes {y['gram_routes']}: an FMA launch")
        print(f"  {tag} rows [{s0}, {s1}) of every head against keys [0, {s1}); resident "
              f"state {y['bytes'] / 1e9:.3f} GB = the reckoning ({100 * y['bytes'] / whole_bytes:.1f}% "
              f"of the whole {whole_bytes / 1e9:.3f} GB), {y['params'] / 1e9:.4f} B "
              f"parameters; peak {y['peak_gib']:.2f} GiB (the moment-tier steps "
              f"{y['moment_peak_gib']:.2f}; one process {one['peak_gib']:.2f})")
        for i, x in enumerate(y["steps"] + y["gram"]):
            c = x["coll"]
            coll_ms = sum(c["ms"][n] for n in COLLECTIVES)
            gram_step = i >= len(y["steps"])
            cp_line = "; ".join(f"{what} {x['cp'][k]['calls']} calls, "
                                f"{x['cp'][k]['bytes'] / 1e6:.3f} MB"
                                for k, what in CP_KINDS.items())
            print(f"    {'gram ' if gram_step else ''}step {i + 1}: batch {x['batch']}, loss "
                  f"{x['loss']:.5f} (one process {want_losses[i]:.5f}), {x['ms']:.1f} ms "
                  f"(one process {(one['ms'] + one['gram_ms'])[i]:.1f}); the forwards' "
                  f"exchanges: {cp_line}; the split residual: {residual_line(x['residual'])}; "
                  f"tp all-reduces {x['tp']['calls']} calls, "
                  f"{x['tp']['bytes'] / 1e9:.3f} GB; collectives {coll_ms:.1f} ms "
                  f"({100 * coll_ms / x['ms']:.1f}%): {coll_line(c)}")
        print(f"    losses within {rel:.3e} relative, sq_norm_sum {y['sq_norm_sum']:.6e} "
              f"within {sq:.3e} (tol {SHARD_LOSS_RTOL}), batches and buckets {y['buckets']} "
              f"the one process's"
              + (f", gathered parameters within {y['param_gap']:.3e} (tol {SHARD_PARAM_ATOL})"
                 if rk == 0 else "")
              + f"; launches {y['launches']} (= {2 * layers}, {layers}, {layers} x {n_micro} "
              f"microbatches), at the offset form {y['offset']}, all three on tc; tp_counts "
              f"{y['tp_counts']}; the residual's collectives every step the reckoning's; "
              f"{kept_line}")
        print(f"    gram tier, {CP_GRAM_STEPS} steps: psgn widths (Din, Dout) "
              f"{dict(sorted(got_widths.items()))}; launches {got_gram}, psgn routes "
              f"{ {k: v for k, v in y['gram_routes'].items() if k.startswith('psgn')} }")
    print(f"  phase 32 ranks and one process: {time.perf_counter() - t_phase:.1f} s (the gloo "
          f"spawn {spawn_s:.1f} s)")
    free()
    records = cp_kernel_phase()

    def summed(key: str, off: str) -> dict:
        out = {k: sum(res[rk][key][k] for rk in res) for k in res[0][key]}
        out.update({f"{k}@offset": sum(res[rk][off][k] for rk in res) for k in res[0][off]})
        return out

    return ({"context-parallel training (ranks)": summed("launches", "offset"),
             "context-parallel gram steps (ranks)": summed("gram_launches", "gram_offset")},
            records)


# ---------------------------------------------------------------------------
# phase 33: the Mamba mixers split over the tensor-parallel ranks in training
# ---------------------------------------------------------------------------

# falcon-mamba-7b at full width, 4 of 64 layers, on a (data 1, model 2) rung
# of 2 gloo ranks sharing the card (each its 4096 of the 8192 channels); its
# ranks run within phase 25's gloo world (one spawn less), its one-process
# run in the parent before that spawn
MAMBA_TP_WORLD, MAMBA_TP_LAYERS, MAMBA_TP_SEQ, MAMBA_TP_MICRO = 2, 4, 2048, 2
MAMBA_TP_CHUNK, MAMBA_TP_STEPS, MAMBA_TP_SEED = 256, 3, 9
#: the mixers' collectives (``ssm.collective_counts``' kinds)
MAMBA_TP_KINDS = {"in_proj_exchange": "in_proj exchange",
                  "x_proj_all_reduce": "x_proj all-reduce",
                  "out_proj_all_reduce": "out_proj all-reduce",
                  "in_proj_exchange_back": "exchange back",
                  "copy_back": "tp.copy backward"}
#: phase 33's one-process run and its ranks' results
PHASE33: dict = {}


def mamba_tp_cfg():
    return FALCON.replace(num_layers=MAMBA_TP_LAYERS, ssm_chunk=MAMBA_TP_CHUNK, remat=True)


def mamba_tp_batch(cfg, i: int) -> dict:
    return TokenStream(cfg.vocab_size, seed=MAMBA_TP_SEED).batch(i, MAMBA_TP_MICRO,
                                                                 MAMBA_TP_SEQ)


def mamba_tp_one_process(path: str, dev: str = "cuda") -> dict:
    """33's reference in the parent: the run on one process with whole
    state (``make_train_step``, the moment tier, one microbatch a step);
    its final parameters to ``path``."""
    cfg = mamba_tp_cfg()
    opt = sgd(momentum=0.9)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state, step = init_state(params, opt), make_train_step(cfg, opt, 1)
    torch.cuda.reset_peak_memory_stats()
    rec = {"loss": [], "ms": []}
    for i in range(MAMBA_TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, mamba_tp_batch(cfg, i), TRAIN_LR)
        rec["loss"].append(float(metrics["loss"]))
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
    rec["sq_norm_sum"] = state.div_state.sq_norm_sum.item()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save({n: p.detach().cpu() for n, p in params.named_parameters()}, path)
    del state, params, step
    free()
    return rec


class MixerClock:
    """Times the channel-parallel mixers' collectives by kind between two
    synchronisations of the card: the ``in_proj`` exchange and its inverse
    (``dist.plan.permute_blocks_dim0``, told apart by the counts each
    carries), and the tensor-parallel all-reduces (``dist.plan.
    _tp_all_reduce``): ``tp.copy``'s backward by the mixers' counts, the
    other all-reduces of activations by type (``x_proj``'s sum float32,
    ``out_proj``'s in the compute type: falcon-mamba has no other such
    all-reduce over tp; under the split residual the exits' reduce-scatters
    take ``out_proj``'s place, timed by :class:`ResidualClock`); a norm
    scale's gradient (one dim) is not the mixers'."""

    def __init__(self):
        from repro_torch.dist import plan as plan_mod

        self.mod, self.ms = plan_mod, dict.fromkeys(MAMBA_TP_KINDS, 0.0)
        self.inner = (plan_mod.permute_blocks_dim0, plan_mod._tp_all_reduce)
        exchange, reduce = self.inner
        counts = ssm._TP_COUNTS

        def timed(kind, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            if kind is not None:
                self.ms[kind] += 1e3 * (time.perf_counter() - t0)
            return out

        def spy_exchange(x, perm, mesh, axes, c=None):
            kind = "in_proj_exchange" if c is counts["in_proj_exchange"] else \
                "in_proj_exchange_back"
            return timed(kind, exchange, x, perm, mesh, axes, c)

        def spy_reduce(x, group, c=None):
            if c is counts["copy_back"]:
                kind = "copy_back"
            elif c is None and x.dim() > 1:
                kind = "x_proj_all_reduce" if x.dtype == torch.float32 else \
                    "out_proj_all_reduce"
            else:
                kind = None
            return timed(kind, reduce, x, group, c)

        plan_mod.permute_blocks_dim0, plan_mod._tp_all_reduce = spy_exchange, spy_reduce

    def snapshot(self) -> dict:
        return dict(self.ms)

    def close(self) -> None:
        self.mod.permute_blocks_dim0, self.mod._tp_all_reduce = self.inner


def rank_mamba_tp(dev, args) -> dict:
    """33 on a rank: falcon-mamba-7b on the (data 1, model 2) rung, each
    mixer on the rank's 4096 channels, the embedding's d and the head's V
    split: ``MAMBA_TP_STEPS`` moment-tier steps; per step its ms, the
    collectives by kind and the mixers' by kind (calls, bytes, ms); the
    channels the scan saw and the ``in_proj`` rows the product read."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_plan, make_production_mesh

    cfg = mamba_tp_cfg()
    opt = sgd(momentum=0.9)
    plan = make_plan(make_production_mesh(device=dev, tp=MAMBA_TP_WORLD))
    params = place(tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev), plan)
    state, step = init_state(params, opt), make_train_step(cfg, opt, 1, plan=plan)
    tp = sharding.tensor_parallel(sharding.layout_of(params))
    clock, mixer, rclock = CollectiveClock(), MixerClock(), ResidualClock()
    cols = (MAMBA_TP_MICRO, MAMBA_TP_SEQ, cfg.d_model // MAMBA_TP_WORLD)
    scan, sdense, seen, weights = ssm._scan, ssm.dense, set(), set()

    def spy_scan(layer, h, dt, *a):
        seen.add((dt.shape[-1], layer.A_log.shape[0], h.shape[1]))
        return scan(layer, h, dt, *a)

    def spy_dense(x, w, *a, **kw):
        weights.add(tuple(w.shape))
        return sdense(x, w, *a, **kw)

    ssm._scan, ssm.dense = spy_scan, spy_dense
    steps, t0 = [], time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    tf.reset_tp_counts()
    try:
        for i in range(MAMBA_TP_STEPS):
            before, mix0, mc0 = clock.snapshot(), mixer.snapshot(), ssm.collective_counts()
            r0 = rclock.snapshot()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with RematKept(cols) as saved:
                state, metrics = step(state, mamba_tp_batch(cfg, i), TRAIN_LR)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
            mix1, mc1 = mixer.snapshot(), ssm.collective_counts()
            steps.append({"loss": loss, "ms": 1e3 * (time.perf_counter() - t1),
                          "coll": clock_delta(before, clock.snapshot()),
                          "residual": residual_delta(r0, rclock.snapshot()),
                          "kept": saved.bytes,
                          "mixer": {k: {"calls": mc1[k]["calls"] - mc0[k]["calls"],
                                        "bytes": mc1[k]["bytes"] - mc0[k]["bytes"],
                                        "ms": mix1[k] - mix0[k]} for k in MAMBA_TP_KINDS}})
        rec = {"steps": steps, "tp_counts": tf.tp_counts(), "tp_rank": tp.rank,
               "launches": kernels.launch_counts(),
               "seen": sorted(seen), "weights": sorted(weights),
               "sq_norm_sum": state.div_state.sq_norm_sum.item(), "bytes": state_bytes(state),
               "params": sum(p.numel() for p in state.params.parameters()),
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    finally:
        ssm._scan, ssm.dense = scan, sdense
        rclock.close()
        mixer.close()
        clock.close()
    whole = torch.load(args["whole"]) if dist.get_rank() == 0 else None
    gaps = {}
    for n, w in whole_params(state.params).items():
        if whole is not None:
            gaps[n] = (w.float().cpu() - whole[n].float()).abs().max().item()
    rec["param_gaps"] = gaps
    rec["wall_s"] = time.perf_counter() - t0
    del state, params, step, whole
    return rec


def mamba_tp_phase() -> dict[str, dict]:
    """Phase 33, from the runs made within phase 25 (its one-process run in
    the parent, its ranks in phase 25's gloo world): checks and prints
    them; returns nothing launched (falcon-mamba runs no Pallas
    counterpart), as the path's counts."""
    cfg = mamba_tp_cfg()
    layers, t = cfg.num_layers, MAMBA_TP_WORLD
    d, d_inner = cfg.d_model, cfg.ssm_expand * cfg.d_model
    c = d_inner // t
    phase(f"33. the Mamba mixers split over {t} tensor-parallel gloo ranks sharing the card: "
          f"falcon-mamba-7b at full width (d {d}, d_inner {d_inner}, d_state "
          f"{cfg.ssm_state}, dt_rank {cfg.dt_rank}, V {cfg.vocab_size}) and "
          f"{layers} of {FALCON.num_layers} layers on a (data 1, model {t}) rung, S "
          f"{MAMBA_TP_SEQ}, micro batch {MAMBA_TP_MICRO}, ssm_chunk {MAMBA_TP_CHUNK}, remat, "
          f"{MAMBA_TP_STEPS} moment-tier steps; each rank's {c} channels, the embedding's d, "
          f"the head's V and the residual stream's d_model columns ({d // t} a rank) split "
          f"(run within phase 25's gloo world)")
    mine, whole_bytes, mine_params = reckoned_state_bytes(cfg, t, tp_plan_abstract())
    one, res = PHASE33["one"], dict(sorted(PHASE33["res"].items()))
    print(f"  one process, whole state: losses {[round(x, 5) for x in one['loss']]}, step ms "
          f"{[round(x, 1) for x in one['ms']]}; sq_norm_sum {one['sq_norm_sum']:.6e}; peak "
          f"{one['peak_gib']:.2f} GiB")
    dt_rank = cfg.dt_rank
    split = {"tp_split": {"embed": MAMBA_TP_STEPS, "mamba": layers * MAMBA_TP_STEPS,
                          "residual": layers * MAMBA_TP_STEPS, "head": MAMBA_TP_STEPS},
             "tp_whole": {}}
    for rk, y in res.items():
        tag = f"[gloo, world {t}, rank {rk}]"
        if y["bytes"] != mine or y["params"] != mine_params:
            raise AssertionError(f"{tag} holds {y['bytes']} bytes ({y['params']} parameters), "
                                 f"reckoned {mine} ({mine_params})")
        losses = [x["loss"] for x in y["steps"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one["loss"]))
        sq = abs(y["sq_norm_sum"] - one["sq_norm_sum"]) / one["sq_norm_sum"]
        if rel > SHARD_LOSS_RTOL or sq > SHARD_LOSS_RTOL:
            raise AssertionError(f"{tag} losses {losses} sq_norm_sum {y['sq_norm_sum']} "
                                 f"against {one}")
        gap = max(y["param_gaps"].values()) if y["param_gaps"] else 0.0
        if rk == 0 and gap > SHARD_PARAM_ATOL:
            worst = sorted(y["param_gaps"].items(), key=lambda kv: -kv[1])[:6]
            raise AssertionError(f"{tag} gathered parameters {gap:.3e} from the one-process "
                                 f"run's (tol {SHARD_PARAM_ATOL}): {worst}")
        if y["tp_counts"] != split or any(y["launches"].values()):
            raise AssertionError(f"{tag} tp_counts {y['tp_counts']}, expected {split}; "
                                 f"launches {y['launches']} (no attention: none)")
        # the scan over the rank's channels; in_proj's [x_t | z_t] rows, never whole
        if [tuple(s) for s in y["seen"]] != [(c, c, c)] \
                or (2 * c, d) not in map(tuple, y["weights"]) \
                or (2 * d_inner, d) in map(tuple, y["weights"]):
            raise AssertionError(f"{tag} the scan saw {y['seen']} channels, the mixers' "
                                 f"products weights {y['weights']}")
        # a step: the forward and the remat recompute issue the exchange and
        # the x_proj sum; the backward one exchange back and x_proj's tp.copy
        # all-reduce a mixer.  The split residual's entry and exit take the
        # out_proj all-reduce's and the input's tp.copy's place.  At T 2
        # each rank sends one of its two c-row blocks (the other is its own)
        sent, tokens = c * d * 2, MAMBA_TP_MICRO * MAMBA_TP_SEQ
        x_proj = tokens * (dt_rank + 2 * cfg.ssm_state) * 4
        want = {"in_proj_exchange": (2 * layers, 2 * layers * sent),
                "x_proj_all_reduce": (2 * layers, 2 * layers * x_proj),
                "out_proj_all_reduce": (0, 0),
                "in_proj_exchange_back": (layers, layers * sent),
                "copy_back": (layers, layers * x_proj)}
        for i, x in enumerate(y["steps"]):
            got = {k: (v["calls"], v["bytes"]) for k, v in x["mixer"].items()}
            if got != want:
                raise AssertionError(f"{tag} step {i + 1} the mixers' collectives {got}, "
                                     f"expected {want}")
        kept_line = residual_check(tag, cfg, tp_plan_abstract(), y["steps"],
                                   [1] * len(y["steps"]), MAMBA_TP_MICRO, MAMBA_TP_SEQ)
        print(f"  {tag} channels [{y['tp_rank'] * c}, {(y['tp_rank'] + 1) * c}) of "
              f"{d_inner}: the scan saw {c} channels (dt, A_log, h), in_proj's [x_t | z_t] "
              f"rows ({2 * c}, {d}) and never ({2 * d_inner}, {d}); resident state "
              f"{y['bytes'] / 1e9:.3f} GB = the reckoning ({100 * y['bytes'] / whole_bytes:.1f}% "
              f"of the whole {whole_bytes / 1e9:.3f} GB), {y['params'] / 1e9:.4f} B "
              f"parameters; peak {y['peak_gib']:.2f} GiB (one process {one['peak_gib']:.2f})")
        for i, x in enumerate(y["steps"]):
            cl = x["coll"]
            coll_ms = sum(cl["ms"][n] for n in COLLECTIVES)
            mix = "; ".join(f"{what} {x['mixer'][k]['calls']} calls, "
                            f"{x['mixer'][k]['bytes'] / 1e6:.3f} MB, {x['mixer'][k]['ms']:.1f} ms"
                            for k, what in MAMBA_TP_KINDS.items())
            print(f"    step {i + 1}: loss {x['loss']:.5f} (one process {one['loss'][i]:.5f}), "
                  f"{x['ms']:.1f} ms (one process {one['ms'][i]:.1f}); the mixers' "
                  f"collectives: {mix}; the split residual: {residual_line(x['residual'])}; "
                  f"all collectives {coll_ms:.1f} ms "
                  f"({100 * coll_ms / x['ms']:.1f}%): {coll_line(cl)}")
        print(f"    losses within {rel:.3e} relative, sq_norm_sum {y['sq_norm_sum']:.6e} "
              f"within {sq:.3e} (tol {SHARD_LOSS_RTOL})"
              + (f", gathered parameters within {gap:.3e} (tol {SHARD_PARAM_ATOL})"
                 if rk == 0 else "")
              + f"; tp_counts {y['tp_counts']}; the residual's collectives every step the "
              f"reckoning's; {kept_line}")
    print(f"  phase 33: its one-process run {PHASE33['one_s']:.1f} s, its ranks "
          f"{max(y['wall_s'] for y in res.values()):.1f} s of phase 25's spawn")
    free()
    return {"Mamba tensor-parallel training (ranks)": {
        k: sum(res[rk]["launches"][k] for rk in res) for k in res[0]["launches"]}}


# ---------------------------------------------------------------------------
# phase 29: the dry run's plan against the card
# ---------------------------------------------------------------------------

PLAN_NUM_MICRO, PLAN_STEPS, PLAN_PEAK_TOL = 2, 3, 0.25
POD_PLAN_DEADLINE_S = 900


def start_pod_plan(out_dir: str) -> subprocess.Popen:
    """``python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k``
    (the 256-card mesh) in a process of its own, on the host with no card
    visible; its output goes to files in ``out_dir``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    with open(os.path.join(out_dir, "stdout"), "w") as out, \
            open(os.path.join(out_dir, "stderr"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b",
             "--shape", "train_4k", "--out", out_dir], env=env, stdout=out, stderr=err,
            cwd=str(ROOT), preexec_fn=lambda: os.nice(10))


def plan_phase(smi: str, pod_plan: subprocess.Popen, pod_dir: str) -> None:
    phase(f"29. the dry run's plan against the card: Yi-6B widths, {TRAIN_LAYERS} of 32 "
          f"layers, bf16, remat, micro batch {TRAIN_MICRO}, S {TRAIN_SEQ}, sgd (momentum "
          f"0.9), {PLAN_NUM_MICRO} microbatches a step")
    from repro_torch.launch import dryrun
    from repro_torch.utils import hlo

    cfg = YI.replace(num_layers=TRAIN_LAYERS, remat=True)
    t0 = time.perf_counter()
    plan = dryrun.trace_train(cfg.replace(attn_impl="flash"), None, TRAIN_MICRO, TRAIN_SEQ,
                              PLAN_NUM_MICRO, torch.float32)
    a = plan["analysis"]
    terms = hlo.roofline_terms(a["flops"], a["hbm_bytes_adjusted"],
                               a["collectives"]["total_time_s"])
    bound = terms["step_time_lower_bound_s"]
    print(f"  plan (traced on the host in {time.perf_counter() - t0:.1f} s, flash lane, "
          f"{a['ops']:.0f} ops): state {plan['state_bytes']} bytes, peak "
          f"{a['peak_bytes'] / 2**30:.3f} GiB, {a['flops']:.4e} FLOPs, {a['hbm_bytes'] / 1e12:.4f} "
          f"TB moved op by op ({a['hbm_bytes_adjusted'] / 1e12:.4f} TB without the "
          f"elementwise ops and conversions)")
    print(f"  plan's roofline against {hlo.CARD} published peaks at {hlo.POWER_LIMIT_W} W: "
          f"compute {terms['compute_s']:.4f} s, memory {terms['memory_s']:.4f} s (op by op "
          f"{a['hbm_bytes'] / hlo.HBM_BW:.4f} s); lower bound {bound:.4f} s "
          f"({terms['dominant']}); this card: {smi}")
    for lane in ("flash", "pallas"):
        c = cfg.replace(attn_impl=lane)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = tf.init_params(c, torch.Generator(device="cuda").manual_seed(0), "cuda")
        opt = sgd(momentum=0.9, state_dtype=torch.float32)
        state = init_state(params, opt, torch.float32)
        held = sum(t.numel() * t.element_size() for t in (
            list(params.parameters()) + list(state.opt_state.momentum)
            + list(state.div_state.grad_sum.values())
            + [state.div_state.sq_norm_sum, state.div_state.mb_count,
               state.div_state.sample_count]))
        step = make_train_step(c, opt, PLAN_NUM_MICRO)
        stream = TokenStream(c.vocab_size, seed=0)
        secs, losses = [], []
        for i in range(1 + PLAN_STEPS):
            batch = stream.batch(i, TRAIN_MICRO * PLAN_NUM_MICRO, TRAIN_SEQ)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step(state, batch, TRAIN_LR)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated() - base
        timed = secs[1:]
        print(f"  {lane}{' (the traced lane)' if lane == 'flash' else ' (the kernels)'}: "
              f"state {held} bytes (plan {plan['state_bytes']}); peak {peak / 2**30:.3f} GiB "
              f"(plan {a['peak_bytes'] / 2**30:.3f}, {100 * (peak / a['peak_bytes'] - 1):+.1f}%); "
              f"step ms {[round(1e3 * x, 1) for x in timed]} after a first of "
              f"{1e3 * secs[0]:.1f}, median {1e3 * statistics.median(timed):.1f}, "
              f"{statistics.median(timed) / bound:.2f}x the bound; losses "
              f"{[round(x, 5) for x in losses]}")
        if held != plan["state_bytes"]:
            raise AssertionError(f"{lane}: the state holds {held} bytes, the plan "
                                 f"{plan['state_bytes']}")
        if lane == "flash" and abs(peak - a["peak_bytes"]) > PLAN_PEAK_TOL * a["peak_bytes"]:
            raise AssertionError(f"the flash lane's peak {peak} bytes is not within "
                                 f"{PLAN_PEAK_TOL:.0%} of the plan's {a['peak_bytes']}")
        if min(timed) < bound:
            raise AssertionError(f"{lane}: a step of {min(timed):.4f} s beat the plan's lower "
                                 f"bound {bound:.4f} s")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{lane}: non-finite loss {losses}")
        del state, params, step
    try:
        rc = pod_plan.wait(timeout=POD_PLAN_DEADLINE_S)
    finally:
        if pod_plan.poll() is None:
            pod_plan.kill()
            pod_plan.wait()
    rec_path = os.path.join(pod_dir, "yi-6b__train_4k__pod16x16.json")
    if rc != 0 or not os.path.exists(rec_path):
        with open(os.path.join(pod_dir, "stderr")) as f:
            raise AssertionError(f"the dry run of yi-6b x train_4k exited {rc}: "
                                 f"{f.read()[-2000:]}")
    with open(rec_path) as f:
        rec = json.load(f)
    if rec["status"] != "ok":
        raise AssertionError(f"the dry run of yi-6b x train_4k: {rec.get('error')}")
    print(f"  the dry run (its own process, no card, {rec['trace_s']} s): "
          f"{dryrun.summary(rec)}")
    print(f"  (a plan against {hlo.CARD} published peaks at {hlo.POWER_LIMIT_W} W, not a "
          f"measurement)")
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    phase("1. the card")
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an H100", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}")

    phase("2. build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"  built in {time.perf_counter() - t0:.1f} s")
    for name, rec in info.items():
        print(f"  {name}: nvcc {rec['seconds']:.1f} s")
        for line in rec["ptxas"]:
            if "Used" in line or ("spill" in line and not line.startswith("0 bytes stack")):
                print(f"    {line}")

    pod_dir = tempfile.mkdtemp(prefix="pod_plan_")
    pod_plan = start_pod_plan(pod_dir)
    try:
        return phases(smi, pod_plan, pod_dir)
    finally:
        if pod_plan.poll() is None:
            pod_plan.kill()
            pod_plan.wait()
        shutil.rmtree(pod_dir, ignore_errors=True)


def phases(smi: str, pod_plan: subprocess.Popen, pod_dir: str) -> int:
    """Phases 3-33, then each phase's wall seconds, the kernels' JSON line
    and the last line."""
    records = kernels_phase()
    serve_counts = full_width_phase()
    card_vs_cpu_phase()
    train_counts = train_phase()
    train_card_vs_cpu_phase()
    gram_counts, alone_counts = gram_train_phase()
    gram_card_vs_cpu_phase()
    pod_counts, pod_after_3, pod_final = pod_phase()
    pod_card_vs_cpu_phase()
    lm_resume_counts = lm_resume_phase()
    pod_resume_counts = pod_resume_phase(pod_after_3)
    resnet_resume_phase()
    cli_card_vs_cpu_phase()
    encoder_paths = hubert_phase()
    encoder_card_vs_cpu_phase()
    rank_paths = scale_out_phase(pod_final)
    encoder_paths["encoder dp training (ranks)"] = rank_paths["encoder dp training (ranks)"]
    dense_paths = dense_phase()
    dense_card_vs_cpu_phase()
    moe_paths = moe_phase()
    moe_card_vs_cpu_phase()
    mamba_paths = mamba_phase()
    mamba_card_vs_cpu_phase()
    exact_counts, exact_encoder_counts = exact_phase()
    exact_card_vs_cpu_phase()
    sharded_paths = sharded_phase()
    elastic_local = elastic_local_phase()
    elastic_ranks = elastic_ranks_phase()
    plan_phase(smi, pod_plan, pod_dir)
    tp_paths = tp_phase()
    tp_serve_paths = tp_serve_phase(PHASE31.get("phase28", {}))
    cp_paths, cp_records = cp_phase()
    records += cp_records
    mamba_tp_paths = mamba_tp_phase()
    # launches on the main paths: serving (phase 4), training on the moment
    # tier (phase 6), on the gram tier (phase 8), the standalone per-sample
    # norms (phase 8, last), the pod slice (phase 10) and the resumed runs
    # (phase 12: the LM's steps 5-8, the pod's epoch 3)
    paths = {"serving": serve_counts, "training": train_counts,
             "gram-tier training": gram_counts, "persample_sq_norms_gram": alone_counts,
             "pod training": pod_counts, "checkpoint-resume LM": lm_resume_counts,
             "checkpoint-resume pod": pod_resume_counts,
             "pod training (ranks)": rank_paths["pod training (ranks)"],
             "exact-tier training": exact_counts, **sharded_paths, **tp_paths,
             **tp_serve_paths, **cp_paths, **mamba_tp_paths,
             "elastic serving (local ladder)": elastic_local,
             "elastic serving (ranks)": elastic_ranks}
    encoder_paths["exact-tier encoder"] = exact_encoder_counts
    # a record naming its paths counts those (the dense group's forms, phase
    # 17; kimi-k2's, phase 19), the other non-causal records the encoder's
    # paths (phase 14), the others the rest
    every = {**paths, **encoder_paths, **dense_paths, **moe_paths, **mamba_paths}
    for rec in records:
        counter = rec.pop("counter", rec["name"])
        on = encoder_paths if counter != rec["name"] else paths
        if "paths" in rec:
            on = {k: every[k] for k in rec.pop("paths")}
        rec["launches"] = sum(c[counter] for c in on.values())
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was launched on no path")
    print("\n  launches by path: " + "; ".join(f"{k} {v}" for k, v in every.items()))
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter() - T0]
    print("  phase wall seconds (header to header; 30, 31 and 33 ran inside 25 and 28): "
          + ", ".join(f"{name} {end - t:.1f}" for (name, t), end in zip(PHASE_STARTS, ends)))

    print()
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
