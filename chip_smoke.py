"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          (from the repository root)
    python3 chip_smoke.py --phase qgemm_decode_sweep   (that phase alone)
    python3 chip_smoke.py --phase decode_plan_sweep    (K1, K4 at every ksplit)
    python3 chip_smoke.py --phase expert_block_sweep   (K7 and K10 per call)
    python3 chip_smoke.py --phase k3_sweep             (K3 per call)
    python3 chip_smoke.py --phase graph_spread         (one step's graphs)
    python3 chip_smoke.py --phase grouped_paths        (paths 5 and 6, the
                                                        bits 1/3 K4L/K5 sweep)
    python3 chip_smoke.py --phase ags_path             (K4's ags form at bits
                                                        1-4 and path 7)
    python3 chip_smoke.py --phase wa8_path             (path 8)
    python3 chip_smoke.py --phase engine_serve         (path 9: the engine,
                                                        its server and bench)
    python3 chip_smoke.py --phase speculative          (path 10: speculative
                                                        decoding on BitNet-3B)
    python3 chip_smoke.py --phase gguf_path            (path 11: GGUF files)
    python3 chip_smoke.py --phase per_channel_path     (path 12: per-channel
                                                        w_fp, K1 and K3 at
                                                        bits 1, 3 and 4)
    python3 chip_smoke.py --phase tools_path           (qgemm's non-fused
                                                        forms E1-E4, then
                                                        the tools and the
                                                        CLI in-process)
    python3 chip_smoke.py --phase lut_forms            (K10 at bits 1, 2
                                                        and 4, E3 on f32 x,
                                                        one scale row at
                                                        bits 8)
    python3 chip_smoke.py --phase tp_path              (path 15: tp = 2 as
                                                        two gloo ranks on
                                                        the one card)
    python3 chip_smoke.py --phase attn_forms           (decode attention at
                                                        Dp 256-512 and rep
                                                        12 and 16; the rep
                                                        12 Mistral-Large
                                                        path)
    python3 chip_smoke.py --phase parallel_paths       (paths 16 and 17: sp,
                                                        pp and ep as gloo
                                                        ranks on the card)

Phases, each printing one JSON line before the last two:
  1. the card (nvidia-smi name and power limit, torch's device name);
  2. build the CUDA kernels from tmac_tpu_torch/ops/cuda/csrc with nvcc
     (all sources in parallel), and the synthetic BitNet-3B weights;
  3. kernel K1 (fused act-quant + packed qgemm, N < 64: the prologue and
     the decode matmul, K split over a cluster) against its plain PyTorch
     version at BitNet-3B's shapes, N = 1, 4, 16 and 63, at decode_plan's
     cluster size and at 1 and 8: bit for bit with exact int8 codes and
     int32 sums on the calls without folds, NMSE <= 1e-6 on the folded
     calls;
     kernel K3 (the N >= 64 route: K1's prologue + one wgmma s8 dot, K
     split over a cluster) at N = 64, 65, 256, 1000 and 1024 on every
     linear with its folds, without the residual and the int8 head, at
     large_plan's cluster size and at 1 and 8, and on wo and the head at
     every tile and cluster size, bit for bit; kernel K10 (wo + residual,
     rms_norm, gate_up, SwiGLU, down + residual in one program) on two
     layers, bit for bit, at its plan's grid and at 1, 7 and 100 blocks;
  4. kernel K2 (decode attention, one launch a call, a cluster of blocks
     per KV head) against its plain version, bit for bit, f32 and bf16, on
     256- and 2048-row caches (lengths 1 to 2048, B = 1 and 2, 32 heads of
     rep 1 and 8 of rep 4, split_plan's cluster size and 1, 3, 8 and 16);
  5. path 1, BitNet-3B W1.58A8 at full width (26 layers, hidden 3200,
     head_dim 100), random weights from seed 0: prefill of a 16-token
     prompt and 64 greedy decode steps through the runtime's entry points,
     prefill and decode_loop (its first step eager, then one CUDA graph of
     the step replayed 63 times), with the kernels' launch counts read
     around it (105 K1 and 26 K2 launches per decode step, each wrapper
     counting its call in the loop's eager step and in its one capture);
     a teacher-forced check of the kernel path against the plain versions
     on the card (logits NMSE <= 1e-4, tie-aware argmax agreement 1.0);
     the same 64 steps by an eager loop of decode_step (its rate from CUDA
     events) and by a CUDA graph of the step captured here (the card's own
     time per step), both giving decode_loop's tokens; decode_loop timed
     three times (min, median and max of its replayed step, tokens/s with
     and without the capture's one-time cost); the device time of an
     eager step by kernel from torch.profiler; then the phase
     generate_from_checkpoint: the weights saved with the port's
     checkpoint writer (and a synthetic tokenizer) to a temporary
     directory and loaded back on the card, every tensor byte for byte;
     generate() from the loaded model giving the in-memory model's greedy
     tokens; sampled at temperature 0.8, top-k 40, top-p 0.95, min-p 0.05
     and repeat penalty 1.1, seed 1 twice the same tokens and seed 2
     others; text in and out through the checkpoint's tokenizer; a
     sampler's CUDA graph drawing anew at each replay; perplexity over two
     512-token windows on the kernel path (210 K3 launches) within 1e-6
     of the plain versions'; then the same as the main run for a
     1024-token prefill in chunks of 256 (420 K3 launches, no K1) and 64
     steps of a model made with TMAC_BLOCK_KERNEL=1 (26 K10, 27 K1 and 26
     K2 a step), the block-mode step's graph beside the default mode's at
     the same context; each kernel's device time per decode step or per
     prefill (CUDA graphs of its calls) beside its bound, its plain
     version and a PyTorch yardstick (K3: torch._int_mm on the unpacked
     codes in both layouts of its second operand, the faster one, and a
     bf16 matmul; K10: K1's three calls for the same layer);
  6. path 2, Llama-2-7B W2A16 g128 at full width and depth (32 layers,
     hidden 4096, 32 heads, head_dim 128, FFN 11008, vocab 32000), random
     weights drawn on the card from seed 0 (params_on_card): kernel K4
     (per-group act-quant + grouped-scale packed qgemm) against its plain
     version at the path's shapes, bits 2 and 4 (a one-layer W4A16 model,
     the package's init_params), N = 1, 4, 16 and 63, at the cluster
     sizes of K1's checks (bit for bit with exact codes, scales and code
     sums without folds, NMSE <= 1e-6 with them), and its tensor-core form K4L (from 64 rows) at N = 64, 100, 256
     and 383, bit for bit with every fold, also at group sizes 32 and 96
     (its KT = 32 form, K padded at bits 2); kernel K5 (the grouped route
     from 3 * group_size rows: bf16 activations times weights dequantized
     to bf16, one f32 wgmma dot) at N = 384, 512 and 700, bits 2 and 4,
     and at Phi-3's down with the SwiGLU fold (the bf16 activations and
     dequantized weights byte for byte, the output within
     sqrt(Kp) * 2^-23 of sum |xa * W|); K1 on the int8 head at N = 1, K3
     at 256 and 512;
     prefill of a 1024-token prompt in chunks of 512 and 64 greedy decode
     steps through decode_loop (256 K5 and 2 K3 launches for the prefill;
     128 K4, 1 K1 and 32 K2 per decode step), then the checks and timings
     of path 1's main run (the
     teacher-forced check on the prefill's last position, NMSE <=
     LLAMA_TF_NMSE and <= LLAMA_FLOOR_RATIO times the plain path's own
     f32-order drift there, its argmax where the plain path's lead is
     beyond that drift (noise_gated_argmax), and on the decode steps; the
     same prefill at the first 2 layers, every position's argmax held so),
     K4's at N = 1, K4L and
     K5 side by side at N = 64 to 512 (CUDA graphs),
     K5's and K4L's at N = 384 and 512;
  7. path 3, Mixtral-8x7B W2A16 g128 at full width and depth (32 layers,
     hidden 4096, 32 heads and 8 KV heads, 8 experts top-2 with FFN 14336,
     vocab 32000), random weights drawn on the card from seed 0: kernel K7
     (expert-indexed qgemm, the routed experts' indices read on the
     device, k of them in one launch) against its plain version at the
     path's expert shapes (gate_up 4096 x 28672, down 14336 x 4096 with the
     SwiGLU prologue on each expert's f32 rows) at N = 1 to 4 and, at bits
     4, at Qwen2-MoE-A14B's (3584 x 5120, 2560 x 3584) on a 4-expert stack,
     N = 1 and 4: one expert at every expert, two on routes covering every
     expert, one route at cluster sizes 1 and 8, bit for bit; an index
     outside the stack gives NaN; the select form's MoE MLP of a layer
     captured in a CUDA graph and replayed on tokens whose routes change,
     each replay bit for bit the plain versions'; prefill of a 256-token
     prompt (the MoE layers in the capacity-dispatch form over K4L: 72 K4L
     and 1 K3 launches at MIXTRAL_LAYERS (4) of its 32 layers) and 64
     greedy decode steps through decode_loop (the select form through K7:
     8 K7 (gate_up and down of both routed experts, one call each a
     layer), 8 K4, 4 K2 and 1 K1 launches per step; the step in a CUDA
     graph makes no host sync), then the checks
     and timings of path 1's main run, K7's per call and per step, and
     K4L's device time over a prefill (torch.profiler) beside its bound,
     its plain version's and the bf16 matmul's on the same calls;
  8. path 4, Phi-3-mini W2A16 g128 at full width, PHI3_LAYERS (4) of its
     32 layers (hidden 3072, 32 heads of head_dim 96, FFN 8192, vocab 32064, a
     2047-row sliding window), random weights drawn on the card from seed
     0: kernels K6 (int8 cache and/or window), K8 (current token as an
     operand) and K9 (K8 storing the current row), the same kernel as K2,
     against their plain versions, bit for bit, at Phi-3's shapes (at
     split_plan's cluster size and at 1 and 8) and a GQA shape (KV 8, rep
     4, head_dim 128), bf16 and int8 caches, windows 2047 and 0, lengths 0
     to 2432 (K9's stored rows byte for byte, the rest of the cache
     untouched, the store at cached length S on row S - 1); K4 at Phi-3's
     shapes (N = 1) and K4L (N = 64, 100, 256, 383); a 2304-token prefill
     (nine chunks of 256, past the window) and 64 greedy decode steps
     through decode_loop on an int8 cache (144 K4L and 9 K3 launches for
     the prefill at PHI3_LAYERS, no K4; 16 K4, 1 K1 and 4 K6 a step), the
     same on a
     bf16 cache, and 64 steps through decode_loop from the int8 prefill's
     cache in the deferred (K8) and in-kernel (K9) KV-write modes, each
     run also by an eager loop giving the same tokens (and cache), the two
     modes agreeing bit for bit (tokens, logits, cache); a teacher-forced
     check of the explicit and in-kernel steps against the plain versions;
     each mode's step captured in a CUDA graph, and decode_loop timed
     three times in each mode; K6, K8 and K9 per call at 2048 cached
     rows beside their byte bound, plain versions and SDPA, K6 at every
     cluster size; K4L per call
     at 256 rows and per prefill, with its share of the prefill's time;
     then writes at the last row of a 128-row cache (a decode step at
     pos == S in each KV-write mode, a 16-token chunk from S - 6, int8 and
     bf16 caches): the rows the reference's clamped writes give, kernel
     and plain paths equal, no device-side assert, and one kernel after;
  9. paths 5 and 6 (grouped_path), weights drawn on the card from seed 0
     at full width: Llama-3.1-8B W3A16 g128 (W3_LAYERS (4) of 32 layers, hidden
     4096, 32 heads over 8 KV heads, FFN 14336, vocab 128256, llama3 rope
     scaling; 3-bit weights as a lo and a hi plane) and Qwen2-7B W4A16
     g128 (28 layers, hidden 3584, 28 heads over 4 KV heads: rep 7, FFN
     18944, vocab 152064, nonzero q/k/v biases): K4 (N = 1, 4, 16 at the
     checks' cluster sizes), K4L (N = 64, 256) and, for Llama-3.1, K5 (N
     = 384, 512) on layer 0's four linears with and without their folds,
     K1 and K3 on the head and K2 at the model's head shape, each against
     its plain version; Llama-3.1's 768-token prompt in chunks of 512 (128
     K5) and 256 (128 K4L), Qwen2's 256 tokens (112 K4L), each with 64
     greedy steps through decode_loop (128 or 112 K4, 1 K1, 32 or 28 K2 a
     step) and path 1's checks and timings (Llama-3.1's teacher-forced
     check on the prompt's last position as path 2's, Qwen2's on every
     position); each kernel's time per step or prefill beside its bound,
     plain version and yardstick; then, on Qwen2-7B's weights and model,
     path 9 (engine_serve): an InferenceEngine of 8 slots and 2048 rows
     (prefill chunks of 512 in buckets of 16, 64, 256 and 512; decode
     chunks of 16 growing to 64; a prefix cache of 4), warmed up, drives
     the serving bench (16 requests at seed 0 of 16-700 tokens, the last
     4 sharing a 300-token prefix, budgets of 32-96 tokens, Poisson
     arrivals), its launches counted against its prefill chunks by bucket
     and its decode steps (112 K4, 1 K1, 28 K2 a step), the decode step's
     device time at 8 active slots from the engine's CUDA events (KV
     lengths of ~80-200 rows and of ~1000), one step of the 8 live slots
     held to the plain versions, a mixed batch (seeded, unseeded and
     seeded-greedy draws, a seed again beside other partners and in
     another slot, logprobs, stop tokens, an eos id, a cancel), a cold
     engine giving the shared-prefix streams, an int8 cache (K6), the HTTP
     server (4 clients, two streaming, each reply the engine's ids), slot
     prefill against generate's prefill bit for bit, 8 greedy streams
     (bf16 and int8 caches) with every batch-dependent form of the step
     set to its one-row form each equal to generate()'s at B = 1 token
     for token, its KV rows bit for bit and its logprob records within
     1e-4 (on the engine's own 8-row plans: reported), and K4, K1 and K2
     (K6) at B = 8 checked and timed per step beside B = 1 and their
     bounds;
 10. K4's ags form (activation groups finer than the weight groups, the
     reference's act_group_size) at bits 1, 2, 3 and 4, ags 32 and 64, N =
     1, 4 and 16 on a 4096 x 4096 weight, without folds (bit for bit, the
     prologue's codes, scales per activation group and weight groups' code
     sums byte for byte) at decode_plan's cluster size and at 1 and 8, and
     with the residual; then path 7 (ags_path, grouped_path), Llama-2-7B
     W2 g128 with zero points at act_group_size 32 (weights drawn on the
     card, seed 0; AGS_LAYERS (4) of 32 layers): K4's ags form (N = 1,
     4, 16) and K4L's (N = 64, 256)
     on layer 0's four linears with and without folds, K5 (N = 384, 512),
     K1 and K3 on the head, K2; a 768-token prompt in chunks of 512 (64
     K5, where the reference keeps float activations) and 256 (64 K4L in
     the ags form), 64 steps at positions 768-831 through decode_loop (64
     K4, 1 K1, 16 K2 a step), teacher-forced as path 5; the prompt's last
     position's logits at ags 32 and at ags 0 against a bf16 dequant
     forward (printed, not gated); K4 per step (also at ags 0 on the same
     weights), K4L and K5 per prefill;
 11. path 8 (mixtral_wa8_path), Mixtral-8x7B's architecture at w_a8 bits 2
     (ternary per-tensor weights drawn on the card, seed 0; 11.3 GB of
     expert codes): K7's per-tensor branch at the path's expert shapes, N =
     1 and 4, and on 4-expert stacks per-tensor at bits 1 and 4 and grouped
     at bits 1 (check_k7: every expert, two-expert routes, cluster sizes 1
     and 8; bit for bit, nonzero zero points), K1 and K3 on the path's
     linears and head, K2 at rep 4; a 256-token prefill (the MoE layers'
     capacity dispatch with every expert's 128 slots on K3: 577 K3) and 64
     select steps through decode_loop (64 K7, 65 K1, 32 K2 a step),
     teacher-forced on every position; K7, K1 per step and K3 per prefill;
 12. the attention sweep: K2 (K6 with Phi-3's window) per call at 1, 64,
     288, 1056 and 2047 rows for the head shapes of the four paths, beside
     SDPA and the byte bound (the fixed cost of a call and its streaming);
 13. the decode-matmul sweep (qgemm_decode_sweep): K1 at BitNet-3B's five
     shapes and K4 at Llama-2-7B's, Phi-3-mini's and Mixtral-8x7B's four,
     and at Llama-3.1-8B's at bits 3 and 1 and Qwen2-7B's at bits 4 (those
     rows also against the plain version), at N = 1, 4 and 16, per call
     beside the byte bound, the bf16 matmul and the cluster size; K4L (N =
     64, 256) and K5 (N = 384, 512) at bits 3 and 1 on Llama-3.1-8B's
     shapes, checked and timed (k4l_k5_sweep_b13); then the programmatic
     launch seen in a profiler trace (pdl_overlap): K1's, K4's and K3's
     matmul starting before its prologue ends, in an eager call and in a
     captured graph;
 14. the expert and block sweep (expert_block_sweep): K7 at Mixtral-8x7B's
     expert shapes, one expert and the two routed experts of a layer
     (gate_up, down and both), N = 1 and 4, with every cluster size, and
     K10 at BitNet-3B's layer shapes, per call beside the byte bound and
     the yardsticks (the bf16 matmul; K1's three calls);
 15. K3's sweep (k3_sweep): K3 per call at BitNet-3B's five prefill
     shapes and Llama-2-7B's int8 head, N = 64, 256 and 1024, beside the
     bound, torch._int_mm in both layouts and the bf16 matmul, with every
     tile and cluster size's time (large_plan's data);
 16. (run right after path 1) path 10 (speculative_path), speculative
     decoding on BitNet-3B (weights drawn on the card, seed 0) with
     BitNet-700M (seed 1) as the draft: K1 at 5 and 9 rows (the
     verification forwards at k = 4 and 8) at both models' shapes and K2
     at the draft's head_dim 96 against their plain versions, bit for bit;
     lookup speculation (k = 8, 3-grams) on a periodic and a random
     64-token prompt, the 700M draft and the target drafting for itself
     (k = 4) on the periodic one, 192 greedy tokens each through graph
     bursts, every wrapper's launches counted against the rounds run
     through the host; gates: (a) the same rounds run eagerly give the
     same tokens and forward counts, (b) the plain versions give the same
     tokens and counts over the first SPEC_PLAIN_NEW tokens, each stream
     against decode_loop's at the same prompt, equal up to a first
     divergence that noise_gated_argmax must not gate (the one-token
     steps' logits there against a verification-shaped forward's);
     both variants at temperature 0.8, top-p 0.95: (c) a seed repeats,
     (b) at one seed; the engine's speculative mode (two greedy requests
     and a seeded sampled one, which takes the normal path and equals the
     plain engine's) against the engine without it; acceptance, bursts,
     host syncs, ms per round and per burst, tokens/s beside
     decode_loop's, eager and graph; a verification forward's device time
     split into K1 (linears, head), the einsum attention and glue, beside
     a one-token step; K1 at 5 and 9 rows and K2 at 96 timed;
 17. (after path 8) path 11 (gguf_path), GGUF files: Llama-3.1-8B at bits
     4, gs 32 with zero points drawn on the card (seed 0, GGUF_LAYERS (16)
     of its 32 layers; GGUF_FULL_RUN_LAYERS (2) in the full run), written by export_gguf as Q4_K (in a temporary directory,
     deleted after) and read back by convert_gguf_model: matmuls at bits 4,
     gs 32 with f32 scales and sub, the int8 head, rope_freqs.weight as the
     factors scaling; the card's torch packers and Q4_K decoder held to the
     numpy ones byte for byte; K4L at K 14336, gs 32 with f32 and bf16
     scales (past the shared memory that staging every group's factors
     took); then grouped_path on the gguf's weights: K4 (N = 1, 4, 16),
     K4L (N = 64, 88), K5 (N = 512) on layer 0's four linears with and
     without folds, a 600-token prompt in chunks of 512 (64 K5) and 88
     (64 K4L), 64 steps through decode_loop (64 K4, 1 K1, 16 K2 a step),
     teacher-forced as path 5, and the kernels' times; then Mixtral-8x7B
     at full width and 2 of its 32 layers through a Q4_K gguf file: K7's
     f32 form (N = 1 and 4, gate_up and down, every expert and cluster
     size), a 64-token prompt (the experts' 32 slots on K4) and 64 steps
     through decode_loop (4 K7, 4 K4, 2 K2, 1 K1 a step), teacher-forced
     on the prompt and 16 steps, K7 per step;
 18. (after path 11) path 12 (per_channel_path), per-channel w_fp
     (group_size -1: one f32 scale and zero point a column, int8
     activations per token): first K1 and K3 at bits 1, 3 and 4 on
     Llama-3.1-8B's four linear shapes (wqkv 4096 x 6144, wo 4096 x 4096,
     gate_up 4096 x 28672, down 14336 x 4096; weights drawn on the card
     with zero points on each column's mean code, seed 17): K1 at N = 1, 4
     and 16 at decode_plan's cluster size and every size of
     DECODE_SPLITS, K3 at N = 64, 256 and 1024 at large_plan's tile and
     split and at every tile and cluster size 1-8, each bit for bit with
     its codes and int32 sums, each form timed (K1 at N = 1, K3 at 512)
     beside its bound, plain version and yardsticks; then Llama-3.1-8B W4A8
     per channel with zero points at full width and depth (seed 0): K1
     (N = 1, 4) and K3 (N = 512) on layer 0's linears with their folds and
     on the int8 head, K2 at rep 4; a 1024-token prompt in chunks of 512
     (258 K3) and 64 steps through decode_loop (129 K1, 32 K2 a step),
     teacher-forced on every position and 8 steps (bit for bit: K1 and K3
     sum integers exactly); K1 per step and K3 per prefill timed;
 19. (after path 12) paths 13, 14 and 14b (gguf_lowbit_path), GGUF's
     Q2_K and Q8_0: first the form checks (lowbit_form_checks) of K4 (N =
     1, 4, 16 at every cluster size), K4L (dispatch "chunk", N = 64, 88)
     and K5 (N = 512) at gs 16 with bits 1-4 and bf16 and f32 scales, and
     at bits 8 with gs 32 and 16, on Llama-3.1-8B's four linear shapes
     (seed 18), bit for bit (K5 within its bound), and K4 and K4L at ags
     16 on a layer of Llama-2-7B W2 g128 with and without its folds; K4L
     at gs 16 and the ags-16 forms timed; then path 13, Llama-3.1-8B at
     full width and depth drawn on the card and written as Q2_K (bits 2,
     gs 16, f32 scales and sub) and read back: K4 (N = 1, 4, 16), K4L (64,
     88) and K5 (512 and 88) on layer 0 with and without folds, a 600-token prompt
     in chunks of 512 and 88 (256 K5: 3 * 16 rows take K5), 64 steps
     through decode_loop (128 K4 at gs 16, 1 K1, 32 K2 a step),
     teacher-forced as path 5; path 14, the same at LB_Q8_LAYERS (16)
     layers through a Q8_0 file (bits 8, gs 32: 64 K5, 64 K4L, 64 K4 a
     step); path 14b, Mixtral-8x7B at 2 of 32 layers through a Q2_K file:
     K7 at gs 16 (N = 1 and 4, every expert and cluster size), 64 tokens
     (wqkv and wo on K5, the experts' slots on K4) and 64 steps (4 K7, 4
     K4, 2 K2, 1 K1 a step), teacher-forced on the prompt's last position
     and GGUF_MOE_FORCED (16) steps (path 13: NEW_FORCED); in the full
     run, paths 13 and 14b force LB_FULL_RUN_FORCED (1 and 1) steps,
     path 13 runs LB_FULL_RUN_Q2K_LAYERS (2) of its 32 layers and path
     14 LB_FULL_RUN_Q8_LAYERS (2).
 20. (after path 14b) tools_path: qgemm_pallas's forms whose activations
     come from outside (E1: int8 x at one scale row on K1's EXT instance
     and K3; E2: per-group int8 codes on K4 and K4L; E3: bf16 x on K4's
     native kernel and K4L's native instance; E4: float x on K5), each
     against its plain version at Llama-2-7B's and BitNet-3B's linears
     (act_form_checks; E1 and E2 bit for bit, E3 within sqrt(chunk) *
     2^-23 * sum |x * w|, E4 within K5's bound) and timed; then, every E
     count at 0, the tools in-process (profile on Llama-2-7B at N = 1,
     256, 512 and with act "native", on BitNet-3B with int8 x; microbench;
     autotune into a temporary table and one read of it each, held to the
     plain version; parity at scaled(8)), each E form launched; then the
     CLI (generate, ppl, score, bench-e2e, trace) on a TOOLS_CKPT_LAYERS-
     layer BitNet-3B checkpoint.
 21. (after tools_path) lut_forms: K10 at bits 1, 2 and 4 on BitNet-3B's
     layer shapes (per-tensor weights at each bits drawn on the card, two
     layers, bit for bit at the plan's grid and at 1, 7 and 100 blocks),
     E3 on f32 x (K4's native kernel's f32-x instance, at 1 and 256
     rows: the tensor cores have no f32 x bf16 product) on Llama-2-7B
     W2's three linears within (sqrt(chunk) + 1) * 2^-23 * sum |x * w|,
     and one scale row at bits 8 (Llama-2-7B's int8 head) at 64 and 256
     rows, E2 (also at 1 row) bit for bit and E3 within its bound, through
     K4L's one-unit fold; each against its plain version and timed.
 22. (last) path 15 (tp_path): Llama-2-7B W2 g128 at tp = 2, as two
     processes (torch.multiprocessing, spawn) joined by gloo on the one
     card, at full width and depth (32 layers, 16 of 32 heads a rank),
     weights drawn on the card from seed 0 in init_params(tp=2)'s layout
     (tp_params_on_card) and sharded (tp.shard_params): a 16-token
     prefill, 600 more tokens in chunks of 512 (K5) and 88 (K4L), 64
     greedy steps through make_tp_step (eager: a gloo collective is not
     captured), each rank's launch counts read around it; the step timed
     (CUDA events and the host's clock) beside a step's 64 all-reduces
     alone; each rank's layer-0 calls at its shard-local shapes (K4 at 1
     row, K4L at 88, K5 at 512, K2 on its cache) against their plain
     versions and timed; then BitNet-3B at tp = 2 over 4 of its 26 layers
     (drawn on the card in the same layout): a 256-token prefill (K3) and
     4 steps (K1), its
     K1 and K3 calls at the shard-local shapes checked and timed.  Then,
     in this process on the same weights, teacher-forced along rank 0's
     tokens (67 positions): the shard-sum reference (wo and down as their
     shards' kernels summed, attention in the ranks' split;
     tp_shard_sum_reference), equal to the ranks bit for bit at every
     position, and the single-device forward (wo and down on the JAX
     package's XLA route, one fold over both shards), JAX's tp gate and
     the gap it shows reported, held to the noise floor (tp_gap: the
     tp logits' mean relative rms difference from it at most twice that
     of the port's single-device forward over the same weights unsharded,
     every linear on its kernel); each one's eager step timed.
 23. attn_forms: decode attention (K2, K6, K8, K9) at a cache head_dim
     above 128 and at more than 8 query heads per KV head (Dp 256 at Dl
     256 and 200, rep 12 and 16 at Dp 128, rep 12 at Dp 256, Dp 384 and
     512), bf16 and int8 caches, with and without a window, at 2047 rows
     (K9 also at 2048: its store on row S - 1 by the last rep tile's
     cluster), against their plain versions bit for bit, each form
     timed; then Mistral-Large-Instruct-2407's widths (hidden 12288, 96
     heads over 8 KV heads: rep 12, FFN 28672, vocab 32768) at 2 of its 88
     layers, W2 g128 drawn on the card, through grouped_path (a 256-token
     prefill on K4L, 64 steps of decode_loop with K2 at rep 12,
     teacher-forced against the plain path, timed).
 24. parallel_paths (paths 16 and 17): gloo ranks on the one card, at
     full width and 4 layers: Llama-2-7B W2 at sp 2 (a 1024-token prompt,
     K5 at 512 rows a rank; again in spans of 512 at start 0 and 512, K4L;
     16 steps of decode_loop from the sp cache), at sp 2 x tp 2 (the tp
     decode reading the sp cache) and at pp 2 (512 tokens in microbatches
     of 128, 16 greedy steps through the stages); Mixtral-8x7B W2 at ep 2
     and ep 2 x tp 2, Qwen2-MoE-A14B W4 at ep 2 (its shared expert), 256
     tokens (the dispatch form, K4L) and 16 steps (the dense form, K4;
     never K7), an engine request over ep 2 x tp 2; each held bit for bit
     to its one-process form (sp_one_process, pp_one_process,
     ep_partial_sums) where the split allows it, and against the
     single-device forward by JAX's tolerance or a noise floor
     (single_gate, tp_gap); each ep rank's K4 and K4L at its local
     expert's shapes checked and timed.
In the full run the sweeps come last (full_run_sweeps), the timing
sweeps only while the run has spent less than SWEEPS_BY_S seconds.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Any failed check raises and the script
exits non-zero; so does a machine without a CUDA device.
"""

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import threading
import time

# the kernel timers (the package's timing module imports torch only at a call)
from tmac_tpu_torch.tools.timing import capture, cuda_ms, graph_ms

STEPS, FORCED, MOE_FORCED, PHI3_FORCED, PROFILED = 64, 8, 2, 2, 4
BITNET_PROMPT, LLAMA_PROMPT, PHI3_PROMPT = 16, 256, 2304
BITNET_LONG_PROMPT, LLAMA_LONG_PROMPT, LLAMA_CHUNK = 1024, 1024, 512
FOLDED_NMSE = 1e-6
# K4L's rows: the route's edges (64, 383) and ragged row tiles; the sweep's
K4L_ROWS, K4L_SWEEP = (64, 100, 256, 383), (64, 128, 256, 384, 512)
PATH_NMSE, TIE_MARGIN = 1e-4, 1e-2
# Llama-2-7B's 1024-token prefill through K5 against the plain versions,
# logits NMSE at the last position: K5 and the plain f32 matmul add in other
# orders (each call within ~1e-6 of sum |xa * W|), and 32 random layers
# amplify the bf16 roundings that moves.  Measured on the H100: 8.3e-3.
# On the CPU, at llama-2-7b scaled(8) with 32 layers, changing only the
# plain matmul's sum order (f32 or f64) moves the last position by 2.6e-3
# (2 layers: 7.4e-5).
LLAMA_TF_NMSE = 3e-2
# ... and within LLAMA_FLOOR_RATIO times the drift that the f32 sum order
# alone gives the plain path there (its K5 matmul summed in float64 instead
# of float32): the reference's own noise floor at that depth.  Measured on
# an H100 at 700 W (phase llama_teacher_forced): floor 6.1e-3 at 32 random
# layers; K5, whose tensor cores sum in their own order, 9.5e-3 from the
# float32 plain path and 1.1e-2 from the float64 one.
LLAMA_FLOOR_RATIO = 4.0
# The argmax of a position is held to the plain path's where the plain
# path's top token leads its runner-up by more than NOISE_LEADS times that
# floor's per-logit rms |f32 - f64| there (and by TIE_MARGIN at least): K5
# drifting from the f32 path by 1.25 times the floor's rms, as it does at
# 32 layers, moves the difference of two logits by ~1.8 floor rms, so such
# a lead is ~3.4 of its standard deviations, which the sum order alone
# does not flip.  Below that lead the argmax is reported, not gated.
NOISE_LEADS = 6.0
# The same 1024-token prefill through K5 at Llama-2-7B's full width with
# only its first LLAMA_SHALLOW_LAYERS layers, where the sum order drifts
# the logits by ~1e-4 (CPU, scaled(8), 2 layers: 7.4e-5): every position
# of both chunks held to the noise-gated argmax, at least
# SHALLOW_GATED_SHARE of them gated, and the NMSE to SHALLOW_NMSE and the
# floor rule.
LLAMA_SHALLOW_LAYERS, SHALLOW_NMSE, SHALLOW_GATED_SHARE = 2, 1e-3, 0.5
STEP_MS = {}  # per path: eager and graph step ms, prefill s (the record line)
# paths 3, 4, 5 and 7's depths since the full run took paths 13, 14 and
# 14b, then path 15, then attn_forms and paths 16-17 (PERF.md §4 lists the
# seconds each cut saves): 4 of the 32 layers of Mixtral-8x7B, Phi-3-mini,
# Llama-3.1-8B W3 and Llama-2-7B at ags 32
MIXTRAL_LAYERS = PHI3_LAYERS = W3_LAYERS = AGS_LAYERS = 4


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


class Card:
    """The card, its peaks (the package's platform.device_spec: the data
    sheet's dense rates), and the random inputs of the kernel checks."""

    def __init__(self):
        import numpy as np
        import torch
        self.dev = torch.device("cuda", 0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        self.smi = smi.splitlines()[0] if smi else None
        self.name = torch.cuda.get_device_name(0)
        from tmac_tpu_torch.platform import device_spec
        self.spec = device_spec(self.name)
        self.bw = self.spec.hbm_bytes_per_s
        self.int8_peak = self.spec.int8_tops * 1e12
        self.bf16_peak = self.spec.bf16_tflops * 1e12
        self.rng = np.random.default_rng(1)
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bf16(self, *shape):
        import numpy as np
        import torch
        return torch.from_numpy(self.rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16).to(self.dev)

    def bound_ms(self, nbytes, ops, peak):
        return max(nbytes / self.bw, ops / peak) * 1e3


def yardstick_ms(card, x, qt, copies_for_l2):
    """bf16 x (K-padded) @ the dequantized (Kp, Mp) weights
    (ops.qgemm.dequant_bf16: dequant_baseline_matmul's product without its
    per-call dequantization), in copies that together exceed the 50 MB L2
    when copies_for_l2 (as the packed weights of a decode step do)."""
    import torch
    from tmac_tpu_torch.ops.qgemm import dequant_bf16
    w = dequant_bf16(qt)
    n = 1 if not copies_for_l2 else max(1, min(4, math.ceil(120e6 / w.numel() / 2)))
    copies = [w] + [w.clone() for _ in range(n - 1)]
    xk = torch.nn.functional.pad(x[:, :qt.kdim], (0, qt.kdim_padded - qt.kdim))
    return graph_ms(lambda: [torch.matmul(xk, c) for c in copies]) / len(copies)


def qgemm_bytes(qt, x, kw):
    """Bytes one call must move: packed weights (both planes at bits 3),
    scales and sub, x, the f32 output, the residual and the norm weight,
    each once."""
    N = x.shape[0]
    hi = qt.packed_hi.numel() if qt.packed_hi is not None else 0
    return (qt.packed.numel() + hi + 2 * qt.scales.numel() * qt.scales.element_size()
            + x.numel() * 2 + 4 * N * qt.mdim_padded
            + (2 * N * qt.mdim if kw.get("residual") is not None else 0)
            + (2 * qt.kdim if "norm" in kw else 0))


def expert_bytes(one, k, x):
    """Bytes one K7 call must move for k routed experts of one expert's
    shape `one`: each expert's packed weights, scales and sub and its f32
    output, and x (shared, or a block of rows an expert) once."""
    N = x.shape[-2]
    return (k * (one.packed.numel() + 2 * one.scales.numel() * one.scales.element_size()
                 + 4 * N * one.mdim_padded) + x.numel() * x.element_size())


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

# K3's rows in its checks on BitNet-3B: the route's edge, a ragged 65,
# the prefill chunk, a ragged 1000 and 1024
K3_ROWS = (64, 65, 256, 1000, 1024)
# the decode matmul's cluster sizes every check takes (decode_plan's: None),
# and the rows its checks take on every path
DECODE_SPLITS, DECODE_ROWS = (None, 1, 8), (1, 4, 16, 63)
# path 1's first K1 call (BitNet-3B's wqkv, norm fold, N = 1) repeated
K1_REPEATS = 40


def decode_split_call(x, qt, kw, ksplit):
    """K1's or K4's function on the card at a given cluster size (None:
    decode_plan's, through the wrapper), below 64 rows; kw's act_gs takes
    K4's ags form."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    grouped = qt.scales.shape[0] > 1
    if ksplit is None:
        return (k4.qgemm_grouped if grouped else k1.qgemm_fused)(x, qt, **kw)
    norm, glu, res = kw.get("norm"), kw.get("glu", False), kw.get("residual")
    if grouped:
        ags = kw.get("act_gs", 0)
        codes, xs, xsum = k4.launch_act_quant_grouped(x, qt, norm, glu, ags=ags)
        out = k4.launch_decode_grouped(codes, xs, xsum, qt, res, ksplit, ags=ags)
    else:
        codes, xs, xsum = k1.launch_act_quant(x, qt, norm, glu)
        out = k1.launch_decode(codes, xs, xsum, qt, res, ksplit)
    return qt.slice_m(out)


def check_k1(card, cases, splits=DECODE_SPLITS):
    """K1 against its plain version; cases: (label, x, qt, folds), N < 64,
    each at every cluster size of `splits`: bit for bit without folds
    (with the prologue's codes, scales and code sums byte for byte and
    the int32 sums exact), NMSE <= FOLDED_NMSE with them."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.utils import nmse
    rows, worst = [], 0.0
    for label, x, qt, kw in cases:
        N = x.shape[0]
        want = k1.qgemm_fused_plain(x, qt, **kw)
        if not kw:
            codes, xs, xsum = k1.launch_act_quant(x, qt)
            pc, pxs, pxsum = k1.act_quant_plain(x, qt)
            unit = dataclasses.replace(qt, scales=torch.ones_like(qt.scales),
                                       sub=torch.zeros_like(qt.sub))
            want_acc = k1.int_dot_plain(pc, qt)
        for ksplit in splits:
            try:
                got = decode_split_call(x, qt, kw, ksplit)
            except ValueError as e:  # a forced cluster size that does not fit
                if ksplit is None:
                    raise
                rows.append(dict(shape=label, N=N, ksplit=ksplit, refused=str(e)))
                continue
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            row = dict(shape=label, N=N, ksplit=ksplit or k1.decode_plan(
                N, qt.kdim_padded, qt.mdim_padded, qt.bits, 0, card.sms)[0],
                max_abs_err=err, bitwise=bool(torch.equal(got, want)))
            if kw:
                row["nmse"] = nmse(want.cpu().numpy(), got.cpu().numpy())
                ok = row["nmse"] <= FOLDED_NMSE
            else:
                # no folds: the codes, the int32 sums and the output are exact
                acc = k1.launch_decode(codes, torch.ones_like(xs),
                                       torch.zeros_like(xsum), unit, None, ksplit)
                row.update(codes_equal=bool(torch.equal(codes, pc)),
                           xs_equal=bool(torch.equal(xs, pxs)),
                           xsum_equal=bool(torch.equal(xsum, pxsum)),
                           acc_equal=bool(torch.equal(acc, want_acc.float())),
                           acc_absmax=int(want_acc.abs().max()))
                ok = all(row[k] for k in ("bitwise", "codes_equal", "xs_equal",
                                          "xsum_equal", "acc_equal"))
            rows.append(row)
            if not ok:
                raise AssertionError(f"K1 {label} N={N}: {row}")
    return rows, worst


# K3's forced cluster sizes in every check beside large_plan's (None)
K3_SPLITS = (None, 1, 8)


def check_k3(card, cases, splits=K3_SPLITS):
    """K3 against its plain version, bit for bit (exact int32 sums, the
    same f32 epilogue); cases: (label, x, qt, folds), N >= 64, each through
    the wrapper (large_plan's tile and cluster size) and at the plan's tile
    with every forced cluster size of `splits`.  Without folds also the
    prologue's codes, scales and code sums and the int32 dot itself (unit
    scales, zero sub)."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    rows, worst = [], 0.0
    for label, x, qt, kw in cases:
        N = x.shape[0]
        want = k1.qgemm_fused_plain(x, qt, **kw)
        gots = {ks: (k1.qgemm_large_int(x, qt, **kw) if ks is None
                     else k3_split_call(x, qt, kw, ksplit=ks)) for ks in splits}
        torch.cuda.synchronize()
        err = max(float((g - want).abs().max()) for g in gots.values())
        worst = max(worst, err)
        row = dict(shape=label, bits=qt.bits, N=N, folds=sorted(kw), max_abs_err=err,
                   plan=k1.large_plan(N, qt.kdim_padded, qt.mdim_padded, qt.bits, card.sms),
                   bitwise={str(ks): bool(torch.equal(g, want)) for ks, g in gots.items()})
        ok = all(row["bitwise"].values())
        if not kw:
            codes, xs, xsum = k1.launch_act_quant(x, qt, large_n=True)
            pc, pxs, pxsum = k1.act_quant_plain(x, qt, large_n=True)
            unit = dataclasses.replace(qt, scales=torch.ones_like(qt.scales),
                                       sub=torch.zeros_like(qt.sub))
            acc = k1.launch_large_int(codes, torch.ones_like(xs),
                                      torch.zeros_like(xsum), unit)
            want_acc = k1.int_dot_plain(pc, qt)
            row.update(codes_equal=bool(torch.equal(codes, k1.dp4a_order(pc, qt.bits))),
                       xs_equal=bool(torch.equal(xs, pxs)),
                       xsum_equal=bool(torch.equal(xsum, pxsum)),
                       acc_equal=bool(torch.equal(acc, want_acc.float())),
                       acc_absmax=int(want_acc.abs().max()))
            ok = ok and all(row[k] for k in ("codes_equal", "xs_equal",
                                             "xsum_equal", "acc_equal"))
        rows.append(row)
        if not ok:
            raise AssertionError(f"K3 {label} N={N}: {row}")
    return rows, worst


def check_k3_tiles(card, label, x, qt, kw):
    """K3 at every tile of LARGE_TILES its bits take and every cluster size
    1-8, against the plain version, bit for bit.  -> rows, worst error"""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    want = k1.qgemm_fused_plain(x, qt, **kw)
    rows, worst = [], 0.0
    for tile in k1.LARGE_TILES:
        if qt.bits != 2 and tile[1] != 128:
            continue
        for ks in range(1, k1.LARGE_MAX_SPLIT + 1):
            got = k3_split_call(x, qt, kw, tile, ks)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            rows.append(dict(tile=list(tile), ksplit=ks, bitwise=bool(torch.equal(got, want))))
            if not rows[-1]["bitwise"]:
                raise AssertionError(f"K3 {label} N={x.shape[0]} tile {tile} ksplit {ks}: "
                                     f"max abs error {err}")
    return dict(shape=label, bits=qt.bits, N=x.shape[0], folds=sorted(kw), configs=rows), worst


def k5_bound(xa, w):
    """The f32-accumulation tolerance K5 is held to, per output: sqrt(Kp)
    units of 2^-23 of sum_k |xa[n, k] * W[k, m]|, the typical growth of Kp
    roundings of at most a unit in the last place each, in any order (the
    products of bf16 values are exact in f32).  Measured on the H100 at
    Llama's and Phi-3's shapes: at most 1.3e-6 of the sum, an eighth of
    the bound at Kp = 8192."""
    return (xa.float().abs() @ w.float().abs()) * (w.shape[0] ** 0.5 * 2.0 ** -23)


def check_k5(card, cases, weights_checked=()):
    """K5 against its plain version; cases: (label, x, qt, folds).  The
    exact parts byte for byte: the prologue's bf16 activations, and the
    weights the matmul dequantizes (read back through one-hot activation
    rows, whose products and sums are exact, for each weight not in
    weights_checked); the output within k5_bound of the plain version's
    (max_ratio: the largest |kernel - plain| / sum |xa * W|)."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k5
    from tmac_tpu_torch.utils import nmse
    rows, worst, seen = [], 0.0, set(weights_checked)
    for label, x, qt, kw in cases:
        N = x.shape[0]
        norm, glu = kw.get("norm"), kw.get("glu", False)
        got = k5.qgemm_dequant(x, qt, **kw)
        want = k5.qgemm_dequant_plain(x, qt, **kw)
        xa = k5.launch_act_bf16(x, qt, norm, glu)
        pxa = k5.act_bf16_plain(x, qt, norm, glu)
        w = k5.dequant_weights_plain(qt)
        mag = qt.slice_m(xa.float().abs() @ w.float().abs())
        bound = qt.slice_m(k5_bound(xa, w))
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max())
        worst = max(worst, err)
        row = dict(shape=label, bits=qt.bits, N=N, K=qt.kdim_padded, max_abs_err=err,
                   max_ratio=float((diff / mag.clamp_min(1e-30)).max()),
                   within_bound=bool((diff <= bound).all()),
                   nmse=nmse(want.cpu().numpy(), got.cpu().numpy()),
                   xa_equal=bool(torch.equal(xa.view(torch.int16), pxa.view(torch.int16))))
        if id(qt) not in seen:
            seen.add(id(qt))
            Kp, step = qt.kdim_padded, 1024
            same = True
            for k0 in range(0, Kp, step):
                n = min(step, Kp - k0)
                onehot = torch.zeros((n, Kp), dtype=torch.bfloat16, device=card.dev)
                onehot[torch.arange(n), k0 + torch.arange(n)] = 1.0
                back = k5.launch_dequant_gemm(onehot, qt)
                same &= bool(torch.equal(back, w[k0:k0 + n].float()))
            row["weights_equal"] = same
        rows.append(row)
        if not (row["within_bound"] and row["xa_equal"]
                and row.get("weights_equal", True)):
            raise AssertionError(f"K5 {label} N={N}: {row}")
    return rows, worst


# K10's grids checked beside the plan's (0: one block an SM): one block,
# a few, and an uneven split of every phase's units
K10_BLOCKS = (0, 1, 7, 100)


def check_k10(card, cases, grids=K10_BLOCKS):
    """K10 against its plain version, bit for bit, at each grid of `grids`
    (the plan's and others: every partition of the units must give the
    same sums); cases: (label, args) with args (attn, resid, norm_w, wo,
    gate_up, down, eps)."""
    import torch
    from tmac_tpu_torch.ops.cuda import block_kernel as k10
    rows, worst = [], 0.0
    for label, args in cases:
        want = k10.wo_mlp_block_plain(*args)
        for blocks in grids:
            got = k10.wo_mlp_block(*args, blocks=blocks)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            rows.append(dict(shape=label, blocks=blocks or card.sms, max_abs_err=err,
                             bitwise=bool(torch.equal(got, want)),
                             finite=bool(torch.isfinite(got).all())))
            if not (rows[-1]["bitwise"] and rows[-1]["finite"]):
                raise AssertionError(f"K10 {label}: {rows[-1]}")
    return rows, worst


def check_k4(card, cases, splits=DECODE_SPLITS):
    """K4's function against its plain version; cases: (label, x, qt,
    folds), folds with act_gs for the ags form.  Below 64 rows the decode
    form (K4), at every cluster size of `splits`; from 64 rows K4L, through
    the wrapper that ops.qgemm.kernel_for picks.  Bit for bit without folds,
    with the plain prologue's codes, scales and code sums byte for byte;
    K4L bit for bit with every fold too, K4 within FOLDED_NMSE with them."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.qgemm import LARGE_N, kernel_for
    from tmac_tpu_torch.utils import nmse
    rows, worst = [], 0.0
    for label, x, qt, kw in cases:
        N = x.shape[0]
        large = N >= LARGE_N
        # the ags form's arguments only where it is asked for, so that a
        # parent package without it runs the other cases (an A/B)
        ags = kw.get("act_gs", 0)
        aw = dict(ags=ags) if ags else {}
        folds = {k: v for k, v in kw.items() if k != "act_gs"}
        want = k4.qgemm_grouped_plain(x, qt, **kw)
        prologue = {}
        if not folds:
            codes, xs, xsum = k4.launch_act_quant_grouped(x, qt, **aw)
            pc, pxs, pxsum = k4.act_quant_grouped_plain(x, qt, **aw)
            prologue = dict(codes_equal=bool(torch.equal(codes, pc)),
                            xs_equal=bool(torch.equal(xs, pxs)),
                            xsum_equal=bool(torch.equal(xsum, pxsum)))
        for ksplit in ((None,) if large else splits):
            if large:
                got = kernel_for(qt, N, dispatch="chunk",
                                 **({"act_gs": ags} if ags else {}))(x, qt, **folds)
            else:
                try:
                    got = decode_split_call(x, qt, kw, ksplit)
                except ValueError as e:  # a forced cluster size that does not fit
                    if ksplit is None:
                        raise
                    rows.append(dict(shape=label, kernel="K4", N=N, ksplit=ksplit,
                                     refused=str(e)))
                    continue
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            row = dict(shape=label, kernel="K4L" if large else "K4", bits=qt.bits, N=N,
                       folds=sorted(folds), max_abs_err=err,
                       bitwise=bool(torch.equal(got, want)),
                       nmse=nmse(want.cpu().numpy(), got.cpu().numpy()), **prologue)
            if ags:
                row["ags"] = ags
            if not large:
                row["ksplit"] = ksplit or k4.decode_plan(
                    N, qt.kdim_padded, qt.mdim_padded, qt.bits, qt.group_size, card.sms,
                    **aw)[0]
            ok = row["bitwise"] if large or not folds else row["nmse"] <= FOLDED_NMSE
            ok = ok and all(prologue.values())
            rows.append(row)
            if not ok:
                raise AssertionError(f"{row['kernel']} {label} N={N}: {row}")
    return rows, worst


# K2's cases: (S, B, KV, rep, lengths, nsplit): the short cache, then long
# contexts at S 2048 (one and two batch rows, 32 heads and Mixtral's 8 of
# rep 4), at split_plan's nsplit (None) and at 1, 3, 8 and 16
K2_CASES = tuple((256, B, KV, rep, lens, None) for B, KV, rep, lens in (
    (1, 32, 1, (1,)), (1, 32, 1, (17,)), (1, 32, 1, (80,)), (1, 32, 1, (256,)),
    (2, 8, 4, (1, 256)), (2, 8, 4, (17, 80)))) + tuple(
    (2048, 1, 32, 1, (n,), None) for n in (1, 17, 255, 1056, 2047, 2048)) + (
    (2048, 2, 32, 1, (1056, 17), None), (2048, 2, 8, 4, (2047, 255), None),
    (2048, 1, 8, 4, (288,), None), (2048, 1, 8, 4, (2048,), None),
    (2048, 1, 32, 1, (1056,), 1), (2048, 1, 32, 1, (2047,), 3),
    (2048, 1, 8, 4, (2047,), 8), (2048, 1, 8, 4, (1056,), 16))


def check_k2(card, Dl):
    """K2 against its plain version on K2_CASES at head_dim Dl, f32 and
    bf16, bit for bit.  A non-portable cluster (nsplit above 8) is held
    where the card schedules it and recorded as refused where not.  ->
    (rows, worst abs error)"""
    import numpy as np
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    dev, rng = card.dev, card.rng
    Dp = 128
    worst, rows = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for S, B, KV, rep, lens, nsplit in K2_CASES:
            kc = torch.zeros((2, B, KV, S, Dp), device=dev)
            vc = torch.zeros_like(kc)
            kc[..., :Dl] = torch.from_numpy(rng.standard_normal((2, B, KV, S, Dl)).astype(np.float32)).to(dev)
            vc[..., :Dl] = torch.from_numpy(rng.standard_normal((2, B, KV, S, Dl)).astype(np.float32)).to(dev)
            q = torch.from_numpy(rng.standard_normal((B, KV, rep, Dl)).astype(np.float32)).to(dev)
            q, kc, vc = q.to(dtype), kc.to(dtype), vc.to(dtype)
            kl = torch.tensor(lens, dtype=torch.int32, device=dev)
            li = torch.tensor([1], dtype=torch.int32, device=dev)
            row = dict(dtype=str(dtype)[6:], S=S, B=B, KV=KV, rep=rep, lens=lens,
                       nsplit=nsplit)
            try:
                got = k2.flash_decode(q, kc, vc, kl, li, nsplit=nsplit)
            except RuntimeError as e:
                if nsplit is None or nsplit <= 8:
                    raise
                rows.append(dict(row, refused=str(e)))
                continue
            want = k2.flash_decode_plain(q, kc, vc, kl, li, nsplit=nsplit)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            rows.append(dict(row, max_abs_err=err, bitwise=bool(torch.equal(got, want))))
            if not rows[-1]["bitwise"]:
                raise AssertionError(f"K2 check failed: {rows[-1]}")
            del kc, vc
    return rows, worst


# ---------------------------------------------------------------------------
# a main path: run, hold to the plain versions, time
# ---------------------------------------------------------------------------

COUNTERS = ("K1", "K4", "K2", "K7", "K6", "K8", "K9", "K3", "K5", "K10", "K4L")


def counters():
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    from tmac_tpu_torch.ops.cuda import block_kernel as k10
    from tmac_tpu_torch.ops.cuda import expert_kernel as k7
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    return (k1.qgemm_fused, k4.qgemm_grouped, ak.flash_decode, k7.qgemm_experts,
            ak.flash_decode_split, ak.flash_decode_append,
            ak.flash_decode_append_write, k1.qgemm_large_int, k4.qgemm_dequant,
            k10.wo_mlp_block, k4.qgemm_grouped_large)


def read_counts():
    return dict(zip(COUNTERS, (f.launches for f in counters())))


def zero_counts():
    for f in counters():
        f.launches = 0


def counts(**kw):
    """Launch counts by kernel label, 0 for every kernel not named."""
    return {k: kw.get(k, 0) for k in COUNTERS}


def graph_decode(model, cache, tok):
    """STEPS greedy decode steps from tok (B,) and cache, replayed from one
    captured CUDA graph of a step: (device ms per step, the tokens)."""
    import torch
    from tmac_tpu_torch.runtime.sampling import sample
    tok0, pos0 = tok.clone(), cache.pos.clone()

    def step():
        lg, _ = model(tok[:, None], cache)
        tok.copy_(sample(lg[:, -1]))
    graph = capture(step)
    tok.copy_(tok0)
    cache.pos.copy_(pos0)
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    replayed = []
    for _ in range(STEPS):
        graph.replay()
        replayed.append(tok.clone())
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / STEPS, torch.cat(replayed).tolist()


KERNEL_NAMES = (("K10", "block_kernel"), ("K3 matmul", "k3_wgmma_kernel"),
                ("K5 prologue", "act_bf16_kernel"), ("K5 matmul", "dequant_wgmma_kernel"),
                ("K4L matmul", "group_mma_kernel"),
                ("K7 prologue", "expert_quant_kernel"),
                ("K7 matmul", "k7_decode_kernel"),
                ("K7 prologue", "expert_quant_token_kernel"),
                ("K7 matmul", "k7_token_kernel"),
                ("K4/K4L prologue", "act_quant_grouped_kernel"),
                ("K4 matmul", "k4_decode_kernel"),
                ("K1 prologue", "act_quant_kernel"), ("K1 matmul", "k1_decode_kernel"),
                ("K2/K6/K8/K9", "decode_attention_kernel"))


def profiled_ms(fn, calls=1, launched=None):
    """Device ms of fn() by kernel (KERNEL_NAMES' labels, the rest as torch
    glue) from torch.profiler, divided by `calls`; `launched`, a dict, gets
    the kernels' launches by label, divided by `calls`."""
    launched = {} if launched is None else launched
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {label: 0.0 for label, _ in KERNEL_NAMES}
    ms["torch glue"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((label for label, k in KERNEL_NAMES if k in e.key),
                   "torch glue")
        ms[key] += e.device_time_total / 1e3 / calls
        launched[key] = launched.get(key, 0) + e.count / calls
    return {k: v for k, v in ms.items() if v}


def eager_decode(model, first, cache, steps=STEPS):
    """`steps` greedy tokens from first (B,) by an eager Python loop of the
    runtime's decode_step, the host launching every kernel of every step:
    (row 0's tokens, device ms per step from CUDA events)."""
    import torch
    from tmac_tpu_torch.runtime.generate import decode_step
    tok, toks = first, []
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        tok, cache = decode_step(model, tok, cache)
        toks.append(tok)
    stop.record()
    torch.cuda.synchronize()
    return torch.stack(toks, 1)[0].tolist(), start.elapsed_time(stop) / steps


def loop_decode(model, first, cache, steps=STEPS):
    """`steps` greedy tokens from first (B,) through the runtime's
    decode_loop, which on the card runs the first step eagerly and replays
    a CUDA graph of it for the rest: (row 0's tokens, its stats: ms per
    replayed step from the loop's own events, host seconds around the
    whole call, setup seconds before the first replay)."""
    import torch
    from tmac_tpu_torch.runtime.generate import decode_loop
    stats = {}
    t0 = time.perf_counter()
    out, _ = decode_loop(model, first, cache, steps, stats=stats)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    if not stats["graph"] or stats["replays"] != steps - 1:
        raise AssertionError(f"decode_loop on the card did not replay a graph: {stats}")
    start, stop = stats.pop("replay_events")
    stats.update(step_ms=start.elapsed_time(stop) / stats["replays"], host_s=host_s)
    return out[0].tolist(), stats


def loop_counts(pre, total):
    """Launch counts of a decode_loop run read around it (pre: before it):
    each wrapper counts its calls, and the loop calls each of a step's
    wrappers twice, in its eager first step and in the one capture, while
    the graph's replays launch without the host.  -> (per step, launched
    on the card: pre + STEPS steps)."""
    per_step = {k: (total[k] - pre[k]) / 2 for k in COUNTERS}
    return per_step, {k: pre[k] + per_step[k] * STEPS for k in COUNTERS}


def loop_rates(card, tag, model, snap, first, want, eager_ms, runs=3):
    """decode_loop timed `runs` times from the prefill's cache snap: tokens/s
    without the capture's one-time cost (ms per replayed step, the card's
    own time) and with it (STEPS over the host's seconds around the call),
    beside the eager loop's rate; each run's tokens must equal `want`.
    Printed as the phase `{tag}_decode_loop`; returns the median ms."""
    rows = []
    for _ in range(runs):
        toks, st = loop_decode(model, first.clone(), clone_cache(snap))
        if toks != want:
            raise AssertionError(f"{tag}: decode_loop gave other tokens")
        rows.append(dict(step_ms=st["step_ms"], tokens_per_s=1e3 / st["step_ms"],
                         tokens_per_s_with_capture=STEPS / st["host_s"],
                         setup_s=st["setup_s"], host_s=st["host_s"]))
    ms = sorted(r["step_ms"] for r in rows)
    say(f"{tag}_decode_loop", steps=STEPS, runs=rows, step_ms_min=ms[0],
        step_ms_median=ms[len(ms) // 2], step_ms_max=ms[-1],
        tokens_per_s=1e3 / ms[len(ms) // 2],
        tokens_per_s_with_capture=sorted(
            r["tokens_per_s_with_capture"] for r in rows)[len(rows) // 2],
        eager_step_ms=eager_ms, eager_tokens_per_s=1e3 / eager_ms,
        tokens_equal_main_run=True, card=card.name, nvidia_smi=card.smi)
    return ms[len(ms) // 2], ms


def device_time(tag, model, cache, first, step_ms, graph_step_ms):
    """Where an eager decode step's device time goes: torch.profiler's
    kernel times over PROFILED eager steps from first (B,) and cache, by
    kernel and the rest as torch glue; printed as the phase
    `{tag}_device_time`."""
    launched = {}
    per_step = profiled_ms(lambda: eager_decode(model, first, cache, PROFILED),
                           PROFILED, launched)
    busy = sum(per_step.values())
    say(f"{tag}_device_time", ms_per_step=per_step, launches_per_step=launched, busy_ms=busy,
        idle_share_eager=1 - busy / step_ms,
        idle_share_graph=1 - busy / graph_step_ms)


def run_path(card, tag, cfg, params, prompt_len, want_prefill, want_step,
             forced=FORCED, chunk=256, block=False, tf_gate=None,
             tf_last_only=False):
    """Prefill in `chunk`-token pieces + STEPS greedy decode steps through
    the runtime's entry points, prefill and decode_loop (a CUDA graph of
    the step after its first; block: the model made in the block mode),
    the kernels' launch counts read around it; then the teacher-forced
    check against the plain versions over the prompt and `forced` decode
    positions, logits NMSE <= PATH_NMSE and tie-aware argmax agreement 1.0
    (with tf_last_only: the prompt's last position, within tf_gate, and
    the decode steps from the kernel path's cache on both sides); the
    same steps by an eager loop of decode_step and by chip_smoke's own
    captured step (graph_decode), each giving decode_loop's tokens; the
    rates of all three (decode_loop three times); the profiler's breakdown
    of an eager step.
    -> dict: model, cache (after the main run), launches (counted over the
    main run), step_ms (eager), graph_step_ms (graph_decode's), loop_ms
    (decode_loop's median), snap and first (the prefill's cache and first
    token, before the decode), prompt, gen (the main run's tokens)."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.generate import prefill
    from tmac_tpu_torch.runtime.sampling import sample
    from tmac_tpu_torch.utils import argmax_agreement, nmse
    dev = card.dev
    max_len = prompt_len + STEPS
    model = llama_in_mode(cfg, params, "explicit", block=block)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, prompt_len))
    tokens = torch.from_numpy(prompt).to(dev)
    cache = KVCache.create(cfg, 1, max_len, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(model, tokens, cache, chunk=chunk)
    first = sample(logits)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_counts()
    snap = clone_cache(cache)
    out, stats = loop_decode(model, first, cache)
    total = read_counts()
    per_step, on_card = loop_counts(pre, total)
    gen = [int(first[0])] + out
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: prefill logits are not finite")
    if not all(0 <= t < cfg.vocab_size for t in gen) or len(gen) != STEPS + 1:
        raise AssertionError(f"{tag}: tokens out of range: {gen}")
    if pre != want_prefill or per_step != want_step:
        raise AssertionError(f"{tag}: launch counts: prefill {pre}, per step {per_step}")
    if int(cache.pos[0]) != prompt_len + STEPS:
        raise AssertionError(f"{tag}: cache pos {int(cache.pos[0])}")
    say(f"{tag}_main_path", model=cfg.name, bits=params["layers"][0]["wqkv"].bits,
        layers=cfg.num_layers, prompt=prompt_len, steps=STEPS, tokens=gen[:16],
        decode="decode_loop (CUDA graph)", replays=stats["replays"],
        launches_prefill=pre, launches_per_decode_step=per_step,
        launches_total=total, launched_on_card=on_card)

    # teacher-forced: kernel path against the plain versions on the card
    t0 = time.perf_counter()
    plain = llama_in_mode(cfg, params, "explicit", plain=True, block=block)
    worst, agree, pairs = 0.0, [], []
    with torch.no_grad():
        caches = [KVCache.create(cfg, 1, max_len, device=dev) for _ in range(2)]
        if tf_last_only:
            lk, caches[0] = prefill(model, tokens, caches[0], chunk=chunk)
            lp, caches[1] = prefill(plain, tokens, caches[1], chunk=chunk)
            with f64_dequant_plain():
                plain64 = llama_in_mode(cfg, params, "explicit", plain=True, block=block)
                l64, _ = prefill(plain64, tokens, KVCache.create(cfg, 1, max_len, device=dev),
                                 chunk=chunk)
            del plain64
            last_logits = (lp, lk, l64)
            # the decode steps then start from the kernel path's cache on
            # both sides, so they are held to PATH_NMSE
            caches[1] = clone_cache(caches[0])
        else:
            lk, caches[0] = model(tokens, caches[0])
            lp, caches[1] = plain(tokens, caches[1])
            pairs.append((lp[0], lk[0]))
        for t in gen[:forced]:
            step = torch.tensor([[t]], device=dev)
            lk, caches[0] = model(step, caches[0])
            lp, caches[1] = plain(step, caches[1])
            pairs.append((lp[0], lk[0]))
    identical = all(torch.equal(ref, got) for ref, got in pairs)
    finite = all(bool(torch.isfinite(got).all()) for _, got in pairs)
    for ref, got in pairs:
        ref, got = ref.float().cpu().numpy(), got.float().cpu().numpy()
        worst = max(worst, nmse(ref, got))
        agree.append(argmax_agreement(ref, got, TIE_MARGIN))
    last, last_ok = {}, True
    if tf_last_only:
        ref, got, ref64 = (t.float().cpu().numpy().reshape(-1) for t in last_logits)
        last = dict(
            prompt_last_nmse=nmse(ref, got), prompt_last_gate=tf_gate,
            prompt_last_plain_f32_vs_f64_nmse=nmse(ref, ref64),
            prompt_last_kernel_vs_f64_nmse=nmse(ref64, got),
            # the plain path's lead of its top token over the kernel's top token
            prompt_last_lead_over_kernel_top=float(ref.max() - ref[got.argmax()]),
            prompt_last_logits_std=float(ref.std()),
            prompt_last_argmax_agreement=argmax_agreement(ref, got, TIE_MARGIN),
            prompt_last_plain_f32_vs_f64_argmax_agreement=float(
                ref.argmax() == ref64.argmax()),
            **{f"prompt_last_{k}": v for k, v in noise_gated_argmax(
                *(torch.from_numpy(a)[None] for a in (ref, got, ref64))).items()})
        last["prompt_last_floor_gate"] = LLAMA_FLOOR_RATIO * last[
            "prompt_last_plain_f32_vs_f64_nmse"]
        last_ok = (last["prompt_last_nmse"] <= tf_gate
                   and last["prompt_last_nmse"] <= last["prompt_last_floor_gate"]
                   and last["prompt_last_gated_agreement"] == 1.0)
        finite = finite and bool(np.isfinite(got).all())
    say(f"{tag}_teacher_forced", positions=(1 if tf_last_only else prompt_len) + forced,
        max_nmse=worst, argmax_agreement=min(agree), bitwise=identical, **last,
        finite=finite, seconds=round(time.perf_counter() - t0, 3))
    if not (finite and worst <= PATH_NMSE and min(agree) == 1.0 and last_ok):
        raise AssertionError(f"{tag}: teacher-forced: nmse {worst}, agreement {agree}, "
                             f"prompt's last position {last}")
    del plain, caches, pairs

    # the same steps from the prefill's cache by an eager loop of
    # decode_step (the host launching every kernel) and by a CUDA graph
    # of a step captured here: both must give decode_loop's tokens
    host_t0 = time.perf_counter()
    eager, step_ms = eager_decode(model, first.clone(), clone_cache(snap))
    host_s = time.perf_counter() - host_t0
    say(f"{tag}_decode_rate", tokens_per_s=1e3 / step_ms, step_ms=step_ms,
        host_tokens_per_s=STEPS / host_s, tokens_equal_decode_loop=eager == gen[1:],
        card=card.name, nvidia_smi=card.smi)
    if eager != gen[1:]:
        raise AssertionError(f"{tag}: the eager loop gave other tokens than decode_loop")
    graph_step_ms, replayed = graph_decode(model, clone_cache(snap), first.clone())
    same = replayed == gen[1:]
    say(f"{tag}_decode_graph", step_ms=graph_step_ms,
        tokens_per_s=1e3 / graph_step_ms, tokens_equal_decode_loop=same,
        prefill_host_s=prefill_s)
    if not same:
        raise AssertionError(f"{tag}: graph-replayed decode gave other tokens")
    loop_ms, spread = loop_rates(card, tag, model, snap, first, gen[1:], step_ms)
    STEP_MS[tag] = dict(eager=step_ms, graph=graph_step_ms, loop=loop_ms,
                        loop_min_median_max=[spread[0], spread[len(spread) // 2],
                                             spread[-1]],
                        prefill_s=prefill_s, launched_on_card=on_card)

    # where an eager step's device time goes (torch.profiler, kernels only)
    device_time(tag, model, clone_cache(snap), first, step_ms, graph_step_ms)
    return dict(model=model, cache=cache, launches=total, step_ms=step_ms,
                graph_step_ms=graph_step_ms, loop_ms=loop_ms, snap=snap,
                first=first, prompt=prompt, gen=gen)


def time_k4(card, calls, reps=20):
    """K4's function per call over `calls` [(x, qt, folds)] (K4 below 64
    rows, K4L from there, as kernel_for picks; K1 for per-tensor weights; a
    CUDA graph of them all, the weights cold in L2 when they exceed it): a
    dict of ms, plain ms on the first call's inputs, bound ms (and what
    bounds it), and the bf16 yardstick's ms."""
    from tmac_tpu_torch.ops.qgemm import kernel_for
    x, qt, kw = calls[0]
    N = x.shape[0]
    fn = kernel_for(qt, N, dispatch="chunk")
    ms = graph_ms(lambda: [fn(a, w, **f) for a, w, f in calls],
                  reps=reps) / len(calls)
    plain = kernel_for(qt, N, plain=True, dispatch="chunk")
    plain_ms = cuda_ms(lambda: plain(x, qt, **kw), 3 if N == 1 else 1)
    ops = 2 * N * qt.kdim_padded * qt.mdim_padded
    nbytes = qgemm_bytes(qt, x, kw)
    by = "bytes" if nbytes / card.bw >= ops / card.int8_peak else "operations"
    return dict(N=N, K=qt.kdim_padded, Mp=qt.mdim_padded, ms=ms,
                plain_ms=plain_ms,
                bound_ms=card.bound_ms(nbytes, ops, card.int8_peak), bound_by=by,
                library_ms=yardstick_ms(card, x, qt, N == 1))


def time_head(card, head, N=1):
    """K1 on the int8 head at N rows: (ms, plain ms, bound ms, yardstick ms)."""
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    x = card.bf16(N, head.kdim)
    return (graph_ms(lambda: k1.qgemm_fused(x, head)),
            cuda_ms(lambda: k1.qgemm_fused_plain(x, head), 3),
            card.bound_ms(qgemm_bytes(head, x, {}),
                          2 * head.kdim_padded * head.mdim_padded, card.int8_peak),
            yardstick_ms(card, x, head, True))


def time_k2(card, cfg, cache, kv_len):
    """K2 per call over the real cache at kv_len rows: (ms, plain ms,
    bound ms, SDPA ms)."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    dev, L, Dl = card.dev, cfg.num_layers, cfg.head_dim
    kc, vc = cache.k, cache.v
    KVh, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = card.bf16(1, KVh, rep, Dl)
    kl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    lis = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    ms = graph_ms(lambda: [k2.flash_decode(q, kc, vc, kl, i) for i in lis]) / L
    plain = cuda_ms(lambda: k2.flash_decode_plain(q, kc, vc, kl, lis[1]), 3)
    qs = q.reshape(1, KVh * rep, 1, Dl)
    views = [(kc[i, :, :, :kv_len, :Dl], vc[i, :, :, :kv_len, :Dl]) for i in range(L)]
    gqa = dict(enable_gqa=True) if rep > 1 else {}
    lib = graph_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv, **gqa) for kk, vv in views]) / L
    # the function needs the Dl logical columns of each valid K and V row
    # (the Dp - Dl pad columns are zeros it need not read)
    nbytes = 2 * KVh * kv_len * Dl * 2 + 2 * q.numel() * 2
    bound = card.bound_ms(nbytes, 4 * KVh * rep * kv_len * Dl, card.bf16_peak)
    return ms, plain, bound, lib


def dominant_bound(rows):
    """What bounds a sum of calls (rows with bound_ms, bound_by and
    per_prefill): the side with the larger share of the summed bound."""
    by = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        by[r["bound_by"]] += r["bound_ms"] * r.get("per_prefill", 1)
    return max(by, key=by.get)


def time_k3(card, calls, reps=5):
    """K3 per call over `calls` [(x, qt, folds)] (a CUDA graph of them
    all): ms; on the first call's inputs the plain version's ms, the bound
    (int8 operations or bytes), torch._int_mm on the unpacked int8 codes
    with the second operand row-major (Kp, Mp) and column-major (the
    transpose of a contiguous (Mp, Kp) copy, the layout cuBLASLt's int8
    kernels take), the faster of the two the library yardstick, and a bf16
    matmul on the dequantized weights."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.ops.qgemm import unpack_codes
    x, qt, kw = calls[0]
    N, Kp, Mp = x.shape[0], qt.kdim_padded, qt.mdim_padded
    ms = graph_ms(lambda: [k1.qgemm_large_int(a, w, **f) for a, w, f in calls],
                  reps=reps) / len(calls)
    plain_ms = cuda_ms(lambda: k1.qgemm_fused_plain(x, qt, **kw), 1)
    ops, nbytes = 2 * N * Kp * Mp, qgemm_bytes(qt, x, kw)
    codes = torch.randint(-127, 128, (N, Kp), dtype=torch.int8, device=card.dev)
    w8 = unpack_codes(qt).contiguous()
    w8t = w8.t().contiguous()
    row_major = graph_ms(lambda: torch._int_mm(codes, w8), reps=reps)
    col_major = graph_ms(lambda: torch._int_mm(codes, w8t.t()), reps=reps)
    return dict(N=N, K=Kp, Mp=Mp, ms=ms, plain_ms=plain_ms,
                bound_ms=card.bound_ms(nbytes, ops, card.int8_peak),
                bound_by="bytes" if nbytes / card.bw >= ops / card.int8_peak
                else "operations",
                library_ms=min(row_major, col_major), int_mm_row_major_ms=row_major,
                int_mm_col_major_ms=col_major,
                bf16_matmul_ms=yardstick_ms(card, x, qt, False))


def time_k5(card, calls, reps=5):
    """K5 per call over `calls` [(x, qt, folds)] (a CUDA graph of them
    all): ms, K4L's ms on the same calls, and on the first call's inputs
    the plain version's ms, the bound (bf16 operations or bytes) and a bf16
    matmul on the dequantized weights (the library yardstick)."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k5
    x, qt, kw = calls[0]
    N, Kp, Mp = x.shape[0], qt.kdim_padded, qt.mdim_padded
    ms = graph_ms(lambda: [k5.qgemm_dequant(a, w, **f) for a, w, f in calls],
                  reps=reps) / len(calls)
    k4l_ms = graph_ms(lambda: [k5.qgemm_grouped_large(a, w, **f) for a, w, f in calls],
                      reps=1) / len(calls)
    plain_ms = cuda_ms(lambda: k5.qgemm_dequant_plain(x, qt, **kw), 1)
    ops, nbytes = 2 * N * Kp * Mp, qgemm_bytes(qt, x, kw)
    return dict(N=N, K=Kp, Mp=Mp, ms=ms, k4l_ms=k4l_ms, plain_ms=plain_ms,
                bound_ms=card.bound_ms(nbytes, ops, card.bf16_peak),
                bound_by="bytes" if nbytes / card.bw >= ops / card.bf16_peak
                else "operations",
                library_ms=yardstick_ms(card, x, qt, False))


def sweep_k4l_k5(card, calls_by_shape, reps=5):
    """K4L and K5 per call at K4L_SWEEP rows over each shape's calls
    [(x, qt, folds)] (CUDA graphs of the calls, x cut to N rows), beside
    each one's bound and the bf16 matmul yardstick; printed as the phase
    `k4l_k5_sweep`."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    rows = []
    for N in K4L_SWEEP:
        for shape, calls in calls_by_shape.items():
            cut = [(x[:N].contiguous(), qt, {k: (v[:N].contiguous() if k == "residual" else v)
                                             for k, v in kw.items()})
                   for x, qt, kw in calls]
            x, qt, kw = cut[0]
            ops, nbytes = 2 * N * qt.kdim_padded * qt.mdim_padded, qgemm_bytes(qt, x, kw)
            rows.append(dict(
                shape=shape, N=N, K=qt.kdim_padded, Mp=qt.mdim_padded,
                k4l_ms=graph_ms(lambda: [k4.qgemm_grouped_large(a, w, **f)
                                         for a, w, f in cut], reps=reps) / len(cut),
                k5_ms=graph_ms(lambda: [k4.qgemm_dequant(a, w, **f)
                                        for a, w, f in cut], reps=reps) / len(cut),
                k4l_bound_ms=card.bound_ms(nbytes, ops, card.int8_peak),
                k5_bound_ms=card.bound_ms(nbytes, ops, card.bf16_peak),
                library_ms=yardstick_ms(card, x, qt, False)))
    say("k4l_k5_sweep", rows=rows, card=card.name, nvidia_smi=card.smi)
    return rows


def sweep_b13_large(card):
    """K4L (N = 64, 256) and K5 (N = 384, 512) at bits 3 and 1 on
    Llama-3.1-8B's four linear shapes with their folds (weights drawn on
    the card): each call against its plain version (check_k4: bit for bit;
    check_k5: within its bound), then timed (time_k4, time_k5: a CUDA graph
    of the call) beside its bound and the bf16 matmul on the dequantized
    weights; printed as the phase `k4l_k5_sweep_b13`."""
    import torch
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(13)
    rows = []
    for bits in (3, 1):
        for label, K, M, folds in B13_SHAPES:
            qt = rand_qt_on_card(gen, K, M, bits, 128, card.dev)
            ones = torch.ones(K, dtype=torch.bfloat16, device=card.dev)
            for N in (64, 256, 384, 512):
                kw = dict(glu="glu" in folds)
                if "norm" in folds:
                    kw["norm"] = (ones, 1e-5)
                if "residual" in folds:
                    kw["residual"] = card.bf16(N, M)
                x = card.bf16(N, 2 * K if kw["glu"] else K)
                case = [(label, x, qt, kw)]
                if N < 384:
                    _, err = check_k4(card, case)
                    t = time_k4(card, [case[0][1:]], reps=5)
                else:
                    _, err = check_k5(card, case)
                    t = time_k5(card, [case[0][1:]])
                rows.append(dict(shape=label, bits=bits, kernel="K4L" if N < 384 else "K5",
                                 max_abs_err=err, **t))
            del qt
    say("k4l_k5_sweep_b13", rows=rows, card=card.name, nvidia_smi=card.smi)
    return rows


def time_k10(card, blocks):
    """K10 per call over `blocks` [(attn, resid, norm_w, wo, gate_up, down,
    eps)] (a CUDA graph of one call a layer, the weights cold in L2 as in a
    step), K1's three separate calls for the same layers (wo + residual,
    gate_up + norm, down + SwiGLU + residual), the plain version and the
    byte bound, per layer."""
    from tmac_tpu_torch.ops.cuda import block_kernel as k10
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    n = len(blocks)
    attn, resid, norm_w, wo, gu, dn, eps = blocks[0]
    xg = card.bf16(1, gu.mdim)
    ms = graph_ms(lambda: [k10.wo_mlp_block(*b) for b in blocks]) / n
    three = graph_ms(lambda: [(k1.qgemm_fused(b[0], b[3], residual=b[1]),
                               k1.qgemm_fused(b[1], b[4], norm=(b[2], b[6])),
                               k1.qgemm_fused(xg, b[5], glu=True, residual=b[1]))
                              for b in blocks]) / n
    plain_ms = cuda_ms(lambda: k10.wo_mlp_block_plain(*blocks[0]), 3)
    H = attn.shape[1]
    nbytes = sum(qgemm_bytes(qt, x, {}) - 4 * qt.mdim_padded - x.numel() * 2
                 for qt, x in ((wo, attn), (gu, attn), (dn, xg))) + 3 * 2 * H + 4 * H
    ops = 2 * (wo.kdim * wo.mdim + gu.kdim * gu.mdim + dn.kdim * dn.mdim)
    return dict(ms=ms, k1_three_calls_ms=three, plain_ms=plain_ms,
                bound_ms=card.bound_ms(nbytes, ops, card.int8_peak), bytes=nbytes)


# ---------------------------------------------------------------------------
# path 1: BitNet-3B W1.58A8
# ---------------------------------------------------------------------------

def bitnet_path(card, finish_build):
    """Path 1 (module docstring, phases 2-5 and 10-15); its weights drawn
    while the kernels build, finish_build() -> (nvcc seconds, ptxas's
    report) waiting for them.  -> the kernels' records"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import init_params
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    cfg = get_preset("bitnet-3b")
    t0 = time.perf_counter()
    try:
        params = init_params(cfg, seed=0, device=card.dev)
        torch.cuda.synchronize()
    finally:  # nvcc's processes end before anything leaves here
        init_s = time.perf_counter() - t0
        build_s, ptxas = finish_build()
    from tmac_tpu_torch.ops.cuda import build
    say("build", nvcc_s=round(build_s, 3), sources=list(build.SOURCES),
        nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()},
        ptxas=ptxas, init_params_s=round(init_s, 3),
        waited_for_nvcc_s=round(time.perf_counter() - t0 - init_s, 3))
    layers = params["layers"]
    H, I, eps = cfg.hidden_size, layers[0]["down"].kdim, cfg.rms_norm_eps
    # (weight per layer, x width, folds) at the main path's shapes
    shapes = {
        "wqkv": (lambda l: l["wqkv"], H, lambda l: dict(norm=(l["attn_norm"], eps))),
        "wo": (lambda l: l["wo"], cfg.q_dim, lambda l: dict(residual=True)),
        "gate_up": (lambda l: l["gate_up"], H, lambda l: dict(norm=(l["mlp_norm"], eps))),
        "down": (lambda l: l["down"], 2 * I, lambda l: dict(glu=True, residual=True)),
        "head": (lambda l: params["lm_head"], H, lambda l: {}),
    }

    def k1_args(shape, N, layer):
        get_w, width, folds = shapes[shape]
        qt, kw = get_w(layer), folds(layer)
        if kw.get("residual"):
            kw["residual"] = card.bf16(N, qt.mdim)
        return card.bf16(N, width), qt, kw

    cases = []
    for N in DECODE_ROWS:
        for s_ in shapes:
            x, qt, kw = k1_args(s_, N, layers[0])
            cases += [(s_, x, qt, kw), (s_, x[:, :qt.kdim].contiguous(), qt, {})]
    rows, k1_err = check_k1(card, cases)
    # K1's first check failed once (a full run from a fresh build: wqkv with
    # its norm fold, N = 1, the plan's cluster of 3, NMSE 9.2e-3), never
    # since: the same call again K1_REPEATS times here, in the run's own
    # process after its build, each on a new x at every cluster size
    t_rep = time.perf_counter()
    rep_rows, rep_err = check_k1(card, [("wqkv repeat", *k1_args("wqkv", 1, layers[0]))
                                        for _ in range(K1_REPEATS)])
    say("k1_check", checks=rows, repeats=dict(
        calls=len(rep_rows), max_abs_err=rep_err, worst_nmse=max(r["nmse"] for r in rep_rows),
        s=round(time.perf_counter() - t_rep, 3)))
    k1_err = max(k1_err, rep_err)
    k2_rows, k2_err = check_k2(card, cfg.head_dim)
    say("k2_check", checks=k2_rows)

    # K3 at the prefill shapes, N = 64 to 1024 (a 1000-row tile ragged),
    # with each linear's folds and without the residual (wo, down) or any
    # fold (gate_up), bit for bit at the plan's cluster size and at 1 and 8;
    # then every tile and cluster size on wo and the int8 head
    k3_cases = []
    for N in K3_ROWS:
        for s_ in ("wqkv", "wo", "gate_up", "down", "head"):
            x, qt, kw = k1_args(s_, N, layers[0])
            k3_cases.append((s_, x, qt, kw))
            if s_ in ("wo", "down", "gate_up"):
                k3_cases.append((s_, x, qt, {k: v for k, v in kw.items()
                                              if k == "glu"}))
    k3_rows, k3_err = check_k3(card, k3_cases)
    say("k3_check", checks=k3_rows)
    for s_, N in (("wo", 256), ("head", 1000)):
        row, err = check_k3_tiles(card, s_, *k1_args(s_, N, layers[0]))
        k3_err = max(k3_err, err)
        say("k3_check_tiles", **row)
    # K10 at the layers' shapes, a norm weight other than ones on layer 1
    k10_cases = [(f"layer {i}", (card.bf16(1, H), card.bf16(1, H),
                                 layers[i]["mlp_norm"] if i == 0 else
                                 (1.0 + 0.1 * card.bf16(H)).to(torch.bfloat16),
                                 layers[i]["wo"], layers[i]["gate_up"],
                                 layers[i]["down"], eps)) for i in (0, 1)]
    k10_rows, k10_err = check_k10(card, k10_cases)
    say("k10_check", checks=k10_rows)

    L = cfg.num_layers
    # K1: 4 linears a layer and the head; K2: one call a layer
    main = run_path(card, "bitnet", cfg, params, BITNET_PROMPT,
                    counts(K1=4 * L + 1), counts(K1=4.0 * L + 1, K2=float(L)))
    model, cache, launches = main["model"], main["cache"], main["launches"]
    generate_from_checkpoint(card, cfg, params, main)

    # the long prompt in chunks of 256 (K3: 4 linears a layer and the head
    # a chunk), then the decode steps in the block mode (K10 a layer; K1
    # on wqkv and the head; K2)
    chunks = BITNET_LONG_PROMPT // 256
    block = run_path(card, "bitnet_block", cfg, params, BITNET_LONG_PROMPT,
                     counts(K3=(4 * L + 1) * chunks),
                     counts(K1=L + 1.0, K2=float(L), K10=float(L)), block=True)
    launches_b = block["launches"]
    default = llama_in_mode(cfg, params, "explicit")
    graph_same_ctx, _ = graph_decode(default, clone_cache(block["snap"]),
                                     block["first"].clone())
    say("bitnet_block_vs_default", prompt=BITNET_LONG_PROMPT,
        block_graph_step_ms=block["graph_step_ms"],
        default_graph_step_ms=graph_same_ctx,
        default_graph_step_ms_at_16_tokens=main["graph_step_ms"], card=card.name,
        nvidia_smi=card.smi)
    del default, block, main

    # per-kernel device times at the decode shapes (N=1), each a CUDA graph
    # of its calls over the 26 layers' weights (cold in the 50 MB L2, as in
    # a decode step) replayed
    k1_rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for shape in shapes:
        calls = [k1_args(shape, 1, layers[i]) for i in range(L)]
        if shape == "head":
            calls = calls[:1]
        x, qt, kw = calls[0]
        ms = graph_ms(lambda: [k1.qgemm_fused(a, w, **f) for a, w, f in calls]
                      ) / len(calls)
        plain_ms = cuda_ms(lambda: k1.qgemm_fused_plain(x, qt, **kw), 3)
        lib_ms = yardstick_ms(card, x, qt, True)
        bound = card.bound_ms(qgemm_bytes(qt, x, kw),
                              2 * qt.kdim_padded * qt.mdim_padded, card.int8_peak)
        n = 1 if shape == "head" else L
        k1_rows.append(dict(shape=shape, K=qt.kdim_padded, Mp=qt.mdim_padded,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            library_ms=lib_ms, per_step=n))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms)):
            tot[key] += n * val
    say("k1_times", rows=k1_rows)

    kv_len = BITNET_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, cache, kv_len)
    say("k2_times", kv_len=kv_len, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound, library_ms=k2_lib, per_step=L)

    # K3 per call at N = 256 (CUDA graphs of its calls over 4 layers'
    # weights) and per prefill of BITNET_LONG_PROMPT tokens
    k3_rows, k3_tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                               int_mm_row_major_ms=0.0, int_mm_col_major_ms=0.0,
                               bf16_matmul_ms=0.0)
    for shape in shapes:
        calls = [k1_args(shape, 256, layers[i]) for i in range(min(4, L))]
        row = time_k3(card, calls[:1] if shape == "head" else calls)
        n = chunks * (1 if shape == "head" else L)
        k3_rows.append(dict(shape=shape, per_prefill=n, **row))
        for key in k3_tot:
            k3_tot[key] += n * row[key]
    say("k3_times", rows=k3_rows, per_prefill=dict(k3_tot, calls=(4 * L + 1) * chunks),
        card=card.name, nvidia_smi=card.smi)

    # K10 per call (a CUDA graph over the 26 layers) beside K1's three
    # separate calls for the same layers
    blocks = [(card.bf16(1, H), card.bf16(1, H), layers[i]["mlp_norm"],
               layers[i]["wo"], layers[i]["gate_up"], layers[i]["down"], eps)
              for i in range(L)]
    k10_t = time_k10(card, blocks)
    say("k10_times", per_step=L, **k10_t, card=card.name, nvidia_smi=card.smi)
    del model, cache, params, blocks
    torch.cuda.empty_cache()
    return [
        dict(name="qgemm_large_int (K3)", path="bitnet-3b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_large.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:266",
             launches=launches_b["K3"], max_abs_err=k3_err,
             ms=k3_tot["ms"], plain_ms=k3_tot["plain_ms"],
             bound_ms=k3_tot["bound_ms"], bound_by=dominant_bound(k3_rows),
             library_ms=k3_tot["library_ms"]),
        dict(name="wo_mlp_block (K10)", path="bitnet-3b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/block_kernel.cu",
             replaces="tmac_tpu/ops/pallas/block_kernel.py:222",
             launches=launches_b["K10"], max_abs_err=k10_err,
             ms=k10_t["ms"] * L, plain_ms=k10_t["plain_ms"] * L,
             bound_ms=k10_t["bound_ms"] * L, bound_by="bytes", library_ms=None),
        dict(name="qgemm_fused (K1)", path="bitnet-3b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K1"], max_abs_err=k1_err,
             ms=tot["ms"], plain_ms=tot["plain_ms"],
             bound_ms=tot["bound_ms"], bound_by="bytes",
             library_ms=tot["library_ms"]),
        dict(name="flash_decode (K2)", path="bitnet-3b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
             replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
             launches=launches["K2"], max_abs_err=k2_err,
             ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
             bound_by="bytes", library_ms=k2_lib * L),
    ]


# the generate_from_checkpoint phase: a sampler at its full settings, and
# perplexity over two windows of 512 tokens
CKPT_SAMPLER = dict(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05,
                    repeat_penalty=1.1)
PPL_WINDOW, PPL_REL = 512, 1e-6


def tree_leaves(tree, path="params"):
    """(path, tensor or meta value) of a params tree, dict keys sorted, a
    QuantizedTensor's fields as leaves of their own."""
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}.{i}")
    elif isinstance(tree, QuantizedTensor):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def synthetic_tokenizer(vocab):
    """An SPM tokenizer of `vocab` pieces: the specials, the 256 byte
    pieces (so any text encodes) and word pieces up to the vocabulary."""
    from tmac_tpu_torch.runtime import tokenizer as tk
    toks = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)] + ["\u2581"]
    toks += [f"\u2581w{i}" for i in range(vocab - len(toks))]
    types = [tk.TT_UNKNOWN, tk.TT_CONTROL, tk.TT_CONTROL] + [tk.TT_BYTE] * 256 \
        + [tk.TT_NORMAL] * (vocab - 259)
    scores = [0.0] * 3 + [-20.0] * 256 + [-1.0] + [-2.0] * (vocab - 260)
    return tk.SPMTokenizer(toks, types, scores)


def sampler_graph_check(card, vocab, replays=16):
    """sample() at temperature 1 on uniform logits captured in a CUDA graph
    with its generator registered: consecutive replays must draw anew."""
    import torch
    from tmac_tpu_torch.runtime.sampling import SamplerConfig, sample
    gen = torch.Generator(device=card.dev).manual_seed(3)
    logits = torch.zeros((1, vocab), device=card.dev)
    out = torch.empty((1,), dtype=torch.int32, device=card.dev)
    cfg = SamplerConfig(temperature=1.0)

    def draw():
        out.copy_(sample(logits, gen, cfg))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        draw()
    drawn = []
    for _ in range(replays):
        graph.replay()
        drawn.append(int(out[0]))
    return drawn


def generate_from_checkpoint(card, cfg, params, main):
    """The phase generate_from_checkpoint on BitNet-3B at full width: the
    params saved with the port's writer (and a synthetic tokenizer beside
    them) to a temporary directory and loaded back on the card, every
    tensor byte for byte; generate() from the loaded model, greedy, giving
    the in-memory model's tokens (main: run_path's result); sampled at
    CKPT_SAMPLER, seed 1 twice the same tokens and seed 2 others; text in
    and out through the checkpoint's tokenizer; a sampler's CUDA graph
    drawing anew at each replay; perplexity over two PPL_WINDOW-token
    windows of a seeded stream on the kernel path (K3) within PPL_REL of
    the plain versions'."""
    import os
    import tempfile
    import numpy as np
    import torch
    from tmac_tpu_torch.convert.checkpoint import (WEIGHTS_FILE, load_checkpoint,
                                                   save_checkpoint)
    from tmac_tpu_torch.models.llama import Llama
    from tmac_tpu_torch.runtime.generate import generate
    from tmac_tpu_torch.runtime.perplexity import perplexity
    from tmac_tpu_torch.runtime.sampling import SamplerConfig
    from tmac_tpu_torch.runtime.tokenizer import load_tokenizer
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_checkpoint(tmp, cfg, params)
        synthetic_tokenizer(cfg.vocab_size).save(tmp)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(tmp, WEIGHTS_FILE))
        t0 = time.perf_counter()
        lcfg, lparams = load_checkpoint(tmp, device=card.dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tok = load_tokenizer(tmp)

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape
                    and torch.equal(x.view(torch.uint8), y.view(torch.uint8)))
        return x == y
    a, b = list(tree_leaves(params)), list(tree_leaves(lparams))
    differ = [p for (p, x), (q, y) in zip(a, b) if p != q or not same(x, y)]
    if len(a) != len(b):
        differ.append(f"{len(a)} leaves saved, {len(b)} loaded")
    loaded = Llama(lcfg, lparams)
    prompt = main["prompt"]
    greedy = generate(loaded, prompt, STEPS + 1)[0].tolist()
    sampler = SamplerConfig(**CKPT_SAMPLER)
    sampled = dict(zip(("seed 1", "seed 1 again", "seed 2"), (
        generate(loaded, prompt, STEPS + 1, sampler=sampler, seed=s)[0].tolist()
        for s in (1, 1, 2))))
    ids = tok.encode("hello world")
    text = tok.decode(generate(loaded, np.asarray([ids]), 16)[0].tolist())
    drawn = sampler_graph_check(card, cfg.vocab_size)
    stream = np.random.default_rng(2).integers(0, cfg.vocab_size, 2 * PPL_WINDOW)
    zero_counts()
    ppl = perplexity(loaded, stream, PPL_WINDOW)
    ppl_launches = read_counts()
    ppl_plain = perplexity(Llama(lcfg, lparams, plain=True), stream, PPL_WINDOW)
    rel = abs(ppl["nll"] - ppl_plain["nll"]) / ppl_plain["nll"]
    want_ppl = counts(K3=2 * (4 * cfg.num_layers + 1))
    checks = dict(
        config_equal=lcfg == cfg, leaves=len(a), leaves_differing=differ[:8],
        greedy_equal_in_memory=greedy == main["gen"],
        seed_reproduces=sampled["seed 1"] == sampled["seed 1 again"],
        seeds_differ=sampled["seed 1"] != sampled["seed 2"],
        sampled_in_range=all(0 <= t < cfg.vocab_size
                             for s_ in sampled.values() for t in s_),
        replays_draw_anew=len(set(drawn)) >= len(drawn) - 2,
        ppl_within_plain=rel <= PPL_REL and ppl["tokens"] == 2 * (PPL_WINDOW - 1),
        ppl_launches_as_expected=ppl_launches == want_ppl)
    say("generate_from_checkpoint", model=cfg.name, weights_bytes=nbytes,
        save_s=round(save_s, 3), load_s=round(load_s, 3),
        sampler=CKPT_SAMPLER, tokens={k: v[:12] for k, v in sampled.items()},
        distinct_sampled=len(set(sampled["seed 1"])), prompt_text="hello world",
        prompt_ids=ids, text_out=text[:80], sampler_graph_draws=drawn[:8],
        perplexity=ppl, perplexity_plain=ppl_plain, perplexity_rel_diff=rel,
        ppl_gate=PPL_REL, ppl_launches=ppl_launches, **checks,
        seconds=round(time.perf_counter() - t_phase, 3), card=card.name,
        nvidia_smi=card.smi)
    if differ or not all(v for k, v in checks.items()
                         if k not in ("leaves", "leaves_differing")):
        raise AssertionError(f"generate_from_checkpoint: {checks}")
    del loaded, lparams


# ---------------------------------------------------------------------------
# path 2: Llama-2-7B W2A16 g128
# ---------------------------------------------------------------------------

def llama_path(card):
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import init_params
    cfg = get_preset("llama-2-7b")
    t0 = time.perf_counter()
    params = params_on_card(cfg, 0, card.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg4 = dataclasses.replace(get_preset("llama-2-7b", bits=4), num_layers=1)
    params4 = init_params(cfg4, seed=0, device=card.dev)
    say("llama_build", init_params_s=round(init_s, 3), bits=2,
        layers=cfg.num_layers, w4_layers=cfg4.num_layers)
    layers = params["layers"]
    H, I, eps = cfg.hidden_size, cfg.intermediate_size, cfg.rms_norm_eps

    def k4_args(shape, N, layer, folds=True):
        """(x, qt, folds) of a linear at the main path's shapes.  down at
        bits 2 (K padded 11008 -> 11264) takes silu(g) * u computed
        before it; at bits 4 it folds the SwiGLU."""
        qt = layer[shape]
        if shape in ("wqkv", "gate_up"):
            kw = dict(norm=(layer["attn_norm" if shape == "wqkv" else "mlp_norm"], eps))
            width = H
        elif shape == "wo":
            kw, width = dict(residual=card.bf16(N, qt.mdim)), cfg.q_dim
        else:
            kw = dict(residual=card.bf16(N, qt.mdim))
            width = I
            if qt.kdim_padded == qt.kdim:
                kw["glu"], width = True, 2 * I
        return card.bf16(N, width), qt, kw if folds else {}

    shapes = ("wqkv", "wo", "gate_up", "down")
    cases = []
    for layer in (layers[0], params4["layers"][0]):
        for shape in shapes:
            for N in DECODE_ROWS + K4L_ROWS:
                cases.append((shape, *k4_args(shape, N, layer)))
                x, qt, _ = k4_args(shape, N, layer, folds=False)
                if shape == "down" and x.shape[1] != qt.kdim:
                    x = x[:, :qt.kdim].contiguous()
                cases.append((shape, x, qt, {}))
    rows, k4_err = check_k4(card, cases)
    say("k4_check", checks=rows)
    rows, err = check_k4(card, k4l_group_size_cases(card))
    k4_err = max(k4_err, err)
    say("k4l_check_group_sizes", checks=rows)
    # K5 at the prefill shapes of a chunk of 384 or 512 rows, bits 2 (down
    # with K padded 11008 -> 11264, silu(g) * u before it) and bits 4 (down
    # with the SwiGLU fold), and at Phi-3-mini's down (8192 x 3072, bits
    # 2, unpadded: the SwiGLU fold)
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(5)
    phi3_down = rand_qt_on_card(gen, 8192, 3072, 2, 128, card.dev)
    cases = [(shape, *k4_args(shape, N, layer)) for layer, Ns in (
        (layers[0], (384, 512, 700)), (params4["layers"][0], (512,)))
        for N in Ns for shape in shapes]
    cases.append(("phi-3 down", card.bf16(512, 2 * 8192), phi3_down,
                  dict(glu=True, residual=card.bf16(512, 3072))))
    rows, k5_err = check_k5(card, cases)
    say("k5_check", tolerance="|kernel - plain| <= sqrt(Kp) * 2^-23 * sum_k |xa * W|",
        checks=rows)
    del cases, params4, phi3_down
    head = params["lm_head"]
    rows, k1_err = check_k1(card, [("head", card.bf16(1, H), head, {})])
    say("k1_check_llama_head", checks=rows)
    rows, k3_err = check_k3(card, [("head", card.bf16(N, H), head, {})
                                   for N in (256, LLAMA_CHUNK)])
    say("k3_check_llama_head", checks=rows)
    k2_rows, k2_err = check_k2(card, cfg.head_dim)
    say("k2_check_llama", checks=k2_rows)

    # the prefill in chunks of LLAMA_CHUNK: K5 on 4 linears a layer, K3 on
    # the head, a chunk; a decode step: K4 on 4 linears a layer, K1 on the
    # head, K2 a layer
    L = cfg.num_layers
    chunks = LLAMA_LONG_PROMPT // LLAMA_CHUNK
    main = run_path(card, "llama", cfg, params, LLAMA_LONG_PROMPT,
                    counts(K3=chunks, K5=4 * L * chunks),
                    counts(K1=1.0, K4=4.0 * L, K2=float(L)), chunk=LLAMA_CHUNK,
                    tf_gate=LLAMA_TF_NMSE, tf_last_only=True)
    model, cache, launches = main["model"], main["cache"], main["launches"]
    llama_shallow_check(card, cfg, params, LLAMA_LONG_PROMPT, LLAMA_CHUNK)

    # K4 per call at the decode shapes (N=1, CUDA graphs over the 32
    # layers' weights, cold in L2), beside its bound, its plain version and
    # the bf16 yardstick
    k4_rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for shape in shapes:
        row = time_k4(card, [k4_args(shape, 1, layers[i]) for i in range(L)])
        k4_rows.append(dict(shape=shape, **row))
        for key in tot:
            tot[key] += L * row[key]
    say("k4_times", rows=k4_rows, per_step=dict(tot, calls=4 * L))

    # K4L and K5 side by side at 64 to 512 rows (the data for an H100
    # crossover; it changes no route)
    sweep_k4l_k5(card, {shape: [k4_args(shape, 512, layers[i]) for i in range(min(4, L))]
                        for shape in shapes})

    # K5 per call at N = 384 and 512 (over 4 layers' weights) beside K4L on
    # the same calls, and per prefill of LLAMA_LONG_PROMPT tokens
    k5_rows, k5_tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for N in (384, LLAMA_CHUNK):
        for shape in shapes:
            row = time_k5(card, [k4_args(shape, N, layers[i]) for i in range(min(4, L))])
            k5_rows.append(dict(shape=shape, per_prefill=L * chunks if N == LLAMA_CHUNK
                                else 0, **row))
            if N == LLAMA_CHUNK:
                for key in k5_tot:
                    k5_tot[key] += L * chunks * row[key]
    say("k5_times", rows=k5_rows, per_prefill=dict(k5_tot, calls=4 * L * chunks),
        card=card.name, nvidia_smi=card.smi)

    h_ms, h_plain, h_bound, h_lib = time_head(card, head)
    say("k1_times_llama_head", ms=h_ms, plain_ms=h_plain, bound_ms=h_bound,
        library_ms=h_lib)

    kv_len = LLAMA_LONG_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, cache, kv_len)
    say("k2_times_llama", kv_len=kv_len, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound, library_ms=k2_lib, per_step=L)
    bound_step = tot["bound_ms"] + h_bound + k2_bound * L
    say("llama_step", eager_ms=main["step_ms"], graph_ms=main["graph_step_ms"],
        decode_loop_ms=main["loop_ms"], kernel_bound_ms=bound_step, card=card.name,
        nvidia_smi=card.smi, path_s=round(time.perf_counter() - t0, 3))
    return [
        dict(name="qgemm_dequant (K5)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_large.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:319",
             launches=launches["K5"], max_abs_err=k5_err,
             ms=k5_tot["ms"], plain_ms=k5_tot["plain_ms"],
             bound_ms=k5_tot["bound_ms"], bound_by=dominant_bound(k5_rows),
             library_ms=k5_tot["library_ms"]),
        dict(name="qgemm_grouped (K4)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K4"], max_abs_err=k4_err,
             ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
             bound_by="bytes", library_ms=tot["library_ms"]),
        dict(name="qgemm_fused (K1)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K1"], max_abs_err=k1_err, ms=h_ms,
             plain_ms=h_plain, bound_ms=h_bound, bound_by="bytes",
             library_ms=h_lib),
        dict(name="flash_decode (K2)", path="llama-2-7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
             replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
             launches=launches["K2"], max_abs_err=k2_err,
             ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
             bound_by="bytes", library_ms=k2_lib * L),
    ]


def k4l_group_size_cases(card):
    """K4L's cases at group sizes 32 and 96, which take its KT = 32 form
    (a depth step of 32 k, one step a group at 32): (label, x, qt, folds)
    at BitNet-b1.58-3B's down width (K 8640, M 3200; K padded to 8704 at
    g32 and to 8832 at g96 at bits 2, unpadded at bits 4 with the SwiGLU
    fold) and a fused qkv of K 3072 with the norm fold, at N = 64, 100,
    256 and 383, with every fold and without."""
    import numpy as np
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    rng = np.random.default_rng(32)

    def qt(K, M, bits, gs):
        qmax = (1 << bits) - 1
        wq = rng.integers(0, qmax + 1, (K, M), dtype=np.uint8)
        sc = ((0.5 + rng.random((K // gs, M))) * (2.0 / math.sqrt(K) / (1 << (bits - 1)))
              ).astype(np.float32)
        sub = sc * rng.integers(0, qmax + 1, (K // gs, M)).astype(np.float32)
        return QuantizedTensor.from_quantized(wq, sc, sub, bits, gs,
                                              scale_dtype=torch.bfloat16, device=card.dev)
    cases = []
    for gs in (32, 96):
        down2, down4, qkv = qt(8640, 3200, 2, gs), qt(8640, 3200, 4, gs), qt(3072, 9216, 2, gs)
        assert down2.kdim_padded > 8640 and down4.kdim_padded == 8640
        cases += [(f"down g{gs}", card.bf16(N, 8640), down2,
                   dict(residual=card.bf16(N, 3200))) for N in (100, 383)]
        cases += [(f"down g{gs}", card.bf16(256, 8640), down2, {}),
                  (f"down g{gs}", card.bf16(256, 2 * 8640), down4,
                   dict(glu=True, residual=card.bf16(256, 3200))),
                  (f"wqkv g{gs}", card.bf16(64, 3072), qkv,
                   dict(norm=(card.bf16(3072), 1e-5)))]
    return cases


# ---------------------------------------------------------------------------
# path 3: Mixtral-8x7B W2A16 g128 (MoE)
# ---------------------------------------------------------------------------

def rand_qt_on_card(gen, K, M, bits, gs, dev, scale_dtype=None):
    """Synthetic grouped weights drawn on the card from the seeded
    generator `gen`, with the shapes, dtypes and value ranges of the
    package's init_params: random codes (packed bytes; at bits 3 a lo and
    a hi plane; at bits 8 the signed codes wq - 128 the package stores),
    bf16 scales (0.5 + U) * 2 * std / mid, zero points on each group's mean
    code jittered by -2..2, bf16 sub (at bits 8 shifted by 128 * scale, as
    the package folds the codes' bias into it); scale_dtype (torch.float32:
    GGUF's block scales) the scales' and sub's dtype instead of bf16.  M
    must be a multiple of 128; K is padded as the package pads it (to a
    multiple of p * gs, 8 * gs at bits 1 and 3), the padded groups' scales
    and zero points 0 (x is zero there too)."""
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes
    from tmac_tpu_torch.utils import round_up
    p, qmax, mid = 8 if bits == 3 else 8 // bits, (1 << bits) - 1, 1 << (bits - 1)
    if M % 128 or K % gs:
        raise ValueError(f"({K}, {M}) would need padding of M or a part group at bits {bits}")
    Kp = round_up(K, p * gs)
    G, Kb = Kp // gs, Kp // (4 if bits == 3 else p)
    packed = torch.randint(0, 256, (Kb, M), generator=gen, device=dev,
                           dtype=torch.uint8)
    hi = torch.randint(0, 256, (Kp // 8, M), generator=gen, device=dev,
                       dtype=torch.uint8) if bits == 3 else None
    scales = (0.5 + torch.rand((G, M), generator=gen, device=dev)) \
        * (2.0 / math.sqrt(K) / mid)
    scales[K // gs:] = 0.0
    if bits == 3:
        gmean = unpack_codes(QuantizedTensor(packed, hi, scales, scales, bits, gs, 1, 1, (K, M))
                             ).reshape(G, gs, M).float().mean(1)
    elif bits == 8:
        gmean = (packed.view(torch.int8).float() + 128).reshape(G, gs, M).mean(1)
    else:
        # field j of the chunk of gs packed rows c holds group j * Kb / gs + c
        gmean = torch.cat([((packed >> (bits * j)) & qmax).reshape(-1, gs, M)
                           .float().mean(1) for j in range(p)])
    zq = (gmean.round() + torch.randint(-2, 3, (G, M), generator=gen,
                                        device=dev)).clamp(0, qmax)
    if bits == 8:
        zq = zq - 128
    dt = scale_dtype or torch.bfloat16
    return QuantizedTensor(packed, hi, scales.to(dt), (scales * zq).to(dt), bits, gs, 1, 1,
                           (K, M))


def wa8_qt_on_card(gen, K, M, dev):
    """Per-tensor ternary weights (K, M) drawn on the card, as the
    package's init_params draws w_a8 ones: codes 1..3 (-1, 0, 1 about the
    midpoint) in every field, f32 scales (0.5 + U) / sqrt(K), sub = 2 *
    scale; K padded to a multiple of 16."""
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    from tmac_tpu_torch.utils import round_up
    Kp = round_up(K, 16)
    f = torch.randint(1, 4, (4, Kp // 4, M), generator=gen, device=dev, dtype=torch.uint8)
    packed = f[0] | (f[1] << 2) | (f[2] << 4) | (f[3] << 6)
    del f
    scales = (0.5 + torch.rand((1, M), generator=gen, device=dev)) / math.sqrt(K)
    return QuantizedTensor(packed, None, scales, 2 * scales, 2, Kp, 1, 1, (K, M))


def pt_qt_on_card(gen, K, M, bits, dev, zero_point=True):
    """Weights (K, M) with one scale row at bits 1 to 4 drawn on the card
    (w_fp per channel, group_size -1), as the package's init_params draws
    them: random packed bytes (every code; at bits 3 a lo and a hi plane),
    f32 scales (0.5 + U) * 2 / sqrt(K) / mid, and with zero_point the zero
    points on each column's mean code jittered by -2..2 (a uniform zero
    would leave a coherent per-column offset that makes a deep random
    forward chaotic), else the midpoint; sub = z * scale.  K a multiple of
    4 * 8 / bits (of 32 at bits 3), M of 128."""
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes
    p, qmax, mid = 8 if bits == 3 else 8 // bits, (1 << bits) - 1, 1 << (bits - 1)
    if K % (4 * p) or M % 128:
        raise ValueError(f"({K}, {M}) would need padding at bits {bits}")
    packed = torch.randint(0, 256, (K // (4 if bits == 3 else p), M), generator=gen,
                           device=dev, dtype=torch.uint8)
    hi = torch.randint(0, 256, (K // 8, M), generator=gen, device=dev,
                       dtype=torch.uint8) if bits == 3 else None
    scales = (0.5 + torch.rand((1, M), generator=gen, device=dev)) * (2.0 / math.sqrt(K) / mid)
    qt = QuantizedTensor(packed, hi, scales, scales, bits, K, 1, 1, (K, M))
    if zero_point:
        z = (unpack_codes(qt).float().mean(0, keepdim=True).round()
             + torch.randint(-2, 3, (1, M), generator=gen, device=dev)).clamp(0, qmax)
    else:
        z = torch.full((1, M), float(mid), device=dev)
    return dataclasses.replace(qt, sub=z * scales)


def int8_head_on_card(gen, H, V, dev):
    """A random int8 lm head (H, V): codes and per-column f32 scales, the
    columns padded to a multiple of 128 with zero scales."""
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    from tmac_tpu_torch.utils import round_up
    Vp = round_up(V, 128)
    scales = torch.zeros((1, Vp), device=dev)
    scales[:, :V] = (0.5 + torch.rand((1, V), generator=gen, device=dev)) * 1.4e-3
    packed = torch.randint(0, 256, (H, Vp), generator=gen, device=dev,
                           dtype=torch.uint8)
    return QuantizedTensor(packed, None, scales, torch.zeros_like(scales), 8,
                           H, 1, 1, (H, V))


def params_on_card(cfg, seed, dev):
    """A model's parameter tree at full size, drawn on the card (the
    package's numpy draws take minutes at billions of weights): norms of
    ones, bf16 embedding (and MoE router, and the shared expert's gate where
    the config has one) ~N(0, 0.02), random grouped
    weights (rand_qt_on_card; at bits 3 with their hi planes; at w_a8
    per-tensor ternary ones, wa8_qt_on_card; at group_size -1 per-channel
    ones, pt_qt_on_card), with
    attention_bias nonzero bf16 q/k/v biases ~N(0, 0.5) (the package's
    init_params draws zeros, which would leave the bias adds unchecked), a
    random int8 head."""
    import torch
    from tmac_tpu_torch.models.llama import (padded_intermediate,
                                             padded_moe_intermediate)
    from tmac_tpu_torch.models.moe import stack_experts
    from tmac_tpu_torch.ops.qgemm import fuse_m
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, E, V = cfg.hidden_size, cfg.num_experts, cfg.vocab_size

    def qt(K, M):
        if cfg.quant.mode == "w_a8":
            return wa8_qt_on_card(gen, K, M, dev)
        if cfg.quant.group_size == -1:
            return pt_qt_on_card(gen, K, M, cfg.quant.bits, dev, cfg.quant.zero_point)
        return rand_qt_on_card(gen, K, M, cfg.quant.bits, cfg.quant.group_size, dev)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)

    def mlp():
        if not E:
            I = padded_intermediate(cfg)
            return {"gate_up": fuse_m([qt(H, I), qt(H, I)]), "down": qt(I, H)}
        Ie = padded_moe_intermediate(cfg)
        out = {"moe_router": normal(H, E),
               "experts_gate_up": stack_experts([fuse_m([qt(H, Ie), qt(H, Ie)])
                                                 for _ in range(E)]),
               "experts_down": stack_experts([qt(Ie, H) for _ in range(E)])}
        if cfg.moe_shared_intermediate_size:
            Is = padded_intermediate(dataclasses.replace(
                cfg, intermediate_size=cfg.moe_shared_intermediate_size))
            out.update(shared_gate_up=fuse_m([qt(H, Is), qt(H, Is)]), shared_down=qt(Is, H))
            if cfg.moe_shared_gate:
                out["shared_gate"] = normal(H)
        return out
    def biases():
        if not cfg.attention_bias:
            return {}
        return {name: (torch.randn(width, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                                    ("bv", cfg.kv_dim))}
    ones = torch.ones(H, dtype=torch.bfloat16, device=dev)
    layers = [{
        "attn_norm": ones, "mlp_norm": ones,
        "wqkv": fuse_m([qt(H, cfg.q_dim), qt(H, cfg.kv_dim), qt(H, cfg.kv_dim)]),
        "wo": qt(cfg.q_dim, H), **mlp(), **biases(),
    } for _ in range(cfg.num_layers)]
    head = int8_head_on_card(gen, H, V, dev)
    return {"embed": normal(V, H), "layers": layers, "final_norm": ones,
            "lm_head": head}


def check_k7(card, cases, splits=(1, 8)):
    """K7 against its plain version; cases: (label, x, stack, glu) with x
    (E, N, width): expert e's rows x[e] (f32 for down, as the select form
    gives it the gate_up output; bf16 and shared by every expert for
    gate_up, x[0]).  k = 1 (qgemm_expert) at every expert, and k = 2
    (qgemm_experts, one launch) on routes that cover every expert, one of
    them also at the forced cluster sizes `splits` (a size whose shared
    memory does not fit is recorded as refused): bit for bit, each plain
    expert computed once.  The activation codes, scales and code sums live
    inside the kernel, so the outputs are held bit for bit."""
    import torch
    from tmac_tpu_torch.ops.cuda import expert_kernel as k7
    rows, worst = [], 0.0
    for label, x, st, glu in cases:
        E, N = st.packed.shape[0], x.shape[1]
        shared = not glu
        rows_of = (lambda e: x[0]) if shared else (lambda e: x[e])
        want = [k7.qgemm_expert_plain(rows_of(e), st, e, glu=glu) for e in range(E)]
        errs, done = [], []

        def hold(got, route, ksplit=None):
            torch.cuda.synchronize()
            for j, e in enumerate(route):
                errs.append(float((got[j] - want[e]).abs().max()))
                if not (torch.equal(got[j], want[e]) and bool(torch.isfinite(got[j]).all())):
                    raise AssertionError(f"K7 {label} bits {st.bits} N={N} route {route} "
                                         f"ksplit {ksplit}: max abs error {errs[-1]}")
            done.append(dict(route=list(route), ksplit=ksplit))
        for e in range(E):
            idx = torch.tensor([e], dtype=torch.int32, device=card.dev)
            hold(k7.qgemm_expert(rows_of(e), st, idx, glu=glu)[None], (e,))
        routes = [(e, (e + E // 2 + 1) % E) for e in range(0, E, 2)]
        for r, route in enumerate(routes):
            idx = torch.tensor(route, dtype=torch.int32, device=card.dev)
            xr = x[0] if shared else x[list(route)].contiguous()
            hold(k7.qgemm_experts(xr, st, idx, glu=glu), route)
            for ksplit in (splits if r == 0 else ()):
                try:
                    out = k7.launch_experts(xr, st, idx, glu, ksplit)
                except ValueError as err:  # a forced cluster size that does not fit
                    done.append(dict(route=list(route), ksplit=ksplit, refused=str(err)))
                    continue
                hold(st.slice_m(out), route, ksplit)
        worst = max(worst, max(errs))
        rows.append(dict(shape=label, bits=st.bits, N=N, K=st.kdim, M=st.mdim,
                         experts=E, x_dtype=str(x.dtype), calls=done,
                         max_abs_err=max(errs), bitwise=True))
    return rows, worst


def k7_route_graph(card, layer, cfg, replays=8):
    """The select form's MoE MLP (moe_mlp, moe_impl="select") on one layer
    captured in a CUDA graph and replayed on new tokens, whose routes
    change between replays: each replay against the plain versions run
    eagerly on the same token, bit for bit.  -> the routes seen."""
    import torch
    from tmac_tpu_torch.models.llama import rms_norm
    from tmac_tpu_torch.models.moe import moe_mlp, route_topk, top_k
    x = card.bf16(1, 1, cfg.hidden_size)
    out = torch.empty_like(x)

    def fn():
        out.copy_(moe_mlp(x, layer, cfg, moe_impl="select"))
    graph = capture(fn)
    routes = []
    for _ in range(replays):
        x.copy_(card.bf16(1, 1, cfg.hidden_size) * 4.0)
        graph.replay()
        want = moe_mlp(x, layer, cfg, moe_impl="select", plain=True)
        torch.cuda.synchronize()
        xn = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps).reshape(1, -1)
        cw = route_topk(xn, layer["moe_router"], cfg.num_experts_per_tok,
                        norm_topk=cfg.moe_norm_topk)
        routes.append(top_k(cw[0], cfg.num_experts_per_tok)[1].tolist())
        if not torch.equal(out, want):
            raise AssertionError(f"K7 graph replay, route {routes[-1]}: max abs error "
                                 f"{float((out.float() - want.float()).abs().max())}")
    del graph
    if len({tuple(r) for r in routes}) < 2:
        raise AssertionError(f"K7 graph replay: the route never changed: {routes}")
    return routes


def time_k7_step(card, cfg, layers):
    """K7 per call at decode (N=1), as the select form calls it: the 2 routed
    experts of a layer in one call, gate_up on the shared row, down on
    each expert's f32 gate_up output; CUDA graphs of its calls over the
    layers' stacks (cold in L2, as in a step), beside its plain version,
    byte bound and the bf16 matmul on the routed experts' dequantized
    weights.  -> (rows, per-step totals)"""
    import torch
    from tmac_tpu_torch.models.moe import expert_view
    from tmac_tpu_torch.ops.cuda import expert_kernel as k7
    H, E, L = cfg.hidden_size, cfg.num_experts, len(layers)
    Ie, k = layers[0]["experts_down"].kdim, cfg.num_experts_per_tok
    rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for shape, width, glu in (("gate_up", H, False), ("down", 2 * Ie, True)):
        name = "experts_" + shape
        calls = [((card.bf16(k, 1, width).float() if glu else card.bf16(1, width)),
                  layers[i][name],
                  torch.tensor([(3 * i + j) % E for j in range(k)], dtype=torch.int32,
                               device=card.dev))
                 for i in range(L)]
        x, st, idx = calls[0]
        ms = graph_ms(lambda: [k7.qgemm_experts(a, s_, i_, glu=glu)
                               for a, s_, i_ in calls]) / L
        plain_ms = cuda_ms(lambda: k7.qgemm_experts_plain(x, st, idx, glu=glu), 3)
        one = expert_view(st, 0)
        lib_ms = k * yardstick_ms(card, (x[0] if glu else x).to(torch.bfloat16), one, True)
        nbytes = expert_bytes(one, k, x)
        ops = 2 * k * one.kdim_padded * one.mdim_padded
        bound = card.bound_ms(nbytes, ops, card.int8_peak)
        rows.append(dict(shape=shape, experts=k, K=one.kdim, Mp=one.mdim_padded,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=lib_ms,
                         bytes=nbytes, per_step=L))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms)):
            tot[key] += L * val
    return rows, tot


def mixtral_path(card):
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.moe import expert_view, stack_experts
    from tmac_tpu_torch.ops.cuda import expert_kernel as k7
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
    t_path = time.perf_counter()
    cfg = dataclasses.replace(get_preset("mixtral-8x7b"), num_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = params_on_card(cfg, 0, card.dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layers = params["layers"]
    H, L, E = cfg.hidden_size, cfg.num_layers, cfg.num_experts
    gu0, dn0 = layers[0]["experts_gate_up"], layers[0]["experts_down"]
    Ie = dn0.kdim
    say("mixtral_build", init_params_s=round(init_s, 3), layers=L, experts=E,
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))

    # K7 at the path's expert shapes (bits 2) and Qwen2-MoE-A14B's (bits 4,
    # a random 4-expert stack), N = 1 to 4, k = 1 at every expert and k = 2
    qcfg = get_preset("qwen2-moe-a14b")
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(4)
    Hq, Iq = qcfg.hidden_size, qcfg.moe_intermediate_size
    q4 = [rand_qt_on_card(gen, *km, 4, 128, card.dev)
          for km in ((Hq, Iq), (Hq, Iq), (Iq, Hq)) for _ in range(4)]
    q_gu = stack_experts([fuse_m([q4[i], q4[4 + i]]) for i in range(4)])
    q_dn = stack_experts(q4[8:])
    del q4
    cases = []
    for N in (1, 2, 3, 4):
        cases += [("gate_up", card.bf16(1, N, H), gu0, False),
                  ("down", card.bf16(E, N, 2 * Ie).float(), dn0, True)]
    for N in (1, 4):
        cases += [("qwen gate_up", card.bf16(1, N, Hq), q_gu, False),
                  ("qwen down", card.bf16(4, N, 2 * Iq).float(), q_dn, True)]
    rows, k7_err = check_k7(card, cases)
    # the stack at index e against the plain version on a copy of expert e
    # alone, and an index outside the stack (the output says so: NaN)
    x, e = card.bf16(1, 2 * Ie), 5
    alone = expert_view(dn0, e)
    alone = QuantizedTensor(alone.packed.clone(), None, alone.scales.clone(),
                            alone.sub.clone(), alone.bits, alone.group_size,
                            1, 1, alone.shape, alone.m_segments)
    idx = torch.tensor([e], dtype=torch.int32, device=card.dev)
    copy_equal = torch.equal(k7.qgemm_expert(x, dn0, idx, glu=True),
                             k4.qgemm_grouped_plain(x, alone, glu=True))
    out_of_range = k7.qgemm_expert(x, dn0, torch.tensor([E], dtype=torch.int32,
                                                        device=card.dev), glu=True)
    nan_out = bool(torch.isnan(out_of_range).all())
    # a route with one expert in range and one out: the first as alone
    pair = k7.qgemm_experts(torch.stack([x, x]), dn0,
                            torch.tensor([e, -1], dtype=torch.int32, device=card.dev),
                            glu=True)
    nan_out = nan_out and bool(torch.isnan(pair[1]).all())
    copy_equal = copy_equal and torch.equal(pair[0], k4.qgemm_grouped_plain(
        x, alone, glu=True))
    routes = k7_route_graph(card, layers[0], cfg)
    say("k7_check", at_s=round(time.perf_counter() - t_path, 3), checks=rows,
        expert_copy_equal=copy_equal, out_of_range_gives_nan=nan_out,
        graph_routes=routes)
    if not (copy_equal and nan_out):
        raise AssertionError(f"K7: copy equal {copy_equal}, NaN out of range {nan_out}")
    del cases, q_gu, q_dn, alone, out_of_range, pair
    # K4, K1 and K2 at this path's own shapes and weights
    l0, eps = layers[0], cfg.rms_norm_eps
    k4_cases = [(s_, card.bf16(N, w), l0[s_], kw) for N in DECODE_ROWS + (256,)
                for s_, w, kw in (("wqkv", H, dict(norm=(l0["attn_norm"], eps))),
                                  ("wo", cfg.q_dim, {}))]
    # the dispatch prefill's expert blocks: C = 128 slots through each
    # expert's gate_up (no folds: codes, sums and group dots exact) and down
    # with the SwiGLU fold at bits 2
    C = 128
    for e in (0, 5):
        k4_cases += [(f"expert {e} gate_up", card.bf16(C, H), expert_view(gu0, e), {}),
                     (f"expert {e} down", card.bf16(C, 2 * Ie), expert_view(dn0, e),
                      dict(glu=True))]
    k4_rows, k4_err = check_k4(card, k4_cases)
    k1_rows, k1_err = check_k1(card, [("head", card.bf16(1, H), params["lm_head"], {})])
    k2_rows, k2_err = check_k2(card, cfg.head_dim)
    say("k4_k1_k2_check_mixtral", at_s=round(time.perf_counter() - t_path, 3),
        k4=k4_rows, k1=k1_rows, k2=k2_rows)

    # prefill: wqkv and wo, and each expert's gate_up and down at C = 128
    # slots (K4L), the head at 256 rows (K3); decode: one K7 call for the 2
    # routed experts' gate_up and one for their down a layer
    main = run_path(card, "mixtral", cfg, params, LLAMA_PROMPT,
                    counts(K3=1, K4L=(2 + 2 * E) * L),
                    counts(K1=1.0, K4=2.0 * L, K2=float(L), K7=2.0 * L),
                    forced=MOE_FORCED)
    model, cache, launches = main["model"], main["cache"], main["launches"]

    # K4L over a prefill (wqkv and wo at the prompt's rows, every expert's
    # gate_up and down at its C slots): device ms by torch.profiler, the
    # bound of those calls from their shapes
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.models.moe import expert_capacity
    from tmac_tpu_torch.runtime.generate import prefill
    launched = {}
    by_kernel = profiled_ms(lambda: prefill(
        model, torch.from_numpy(main["prompt"]).to(card.dev),
        KVCache.create(cfg, 1, LLAMA_PROMPT + STEPS, device=card.dev)), launched=launched)
    Cm = expert_capacity(LLAMA_PROMPT, cfg)
    meta = torch.device("meta")
    k4l_calls = [(l0["wqkv"], torch.empty((LLAMA_PROMPT, H), device=meta),
                  dict(norm=None)),
                 (l0["wo"], torch.empty((LLAMA_PROMPT, cfg.q_dim), device=meta),
                  dict(residual=True))] + E * [
        (expert_view(gu0, 0), torch.empty((Cm, H), device=meta), {}),
        (expert_view(dn0, 0), torch.empty((Cm, 2 * Ie), device=meta), dict(glu=True))]
    k4l_bound = L * sum(card.bound_ms(qgemm_bytes(qt, x, kw),
                                      2 * x.shape[0] * qt.kdim_padded * qt.mdim_padded,
                                      card.int8_peak) for qt, x, kw in k4l_calls)
    # the same calls on layer 0's weights (wqkv and wo at the prompt's rows,
    # each expert's gate_up and down at its Cm slots): the plain version
    # eagerly and the bf16 matmul on the dequantized weights (one call
    # each, a CUDA graph), times the layers
    l0_calls = [(card.bf16(LLAMA_PROMPT, H), l0["wqkv"], dict(norm=(l0["attn_norm"], eps))),
                (card.bf16(LLAMA_PROMPT, cfg.q_dim), l0["wo"],
                 dict(residual=card.bf16(LLAMA_PROMPT, H)))]
    l0_calls += [(card.bf16(Cm, H), expert_view(gu0, e), {}) for e in range(E)]
    l0_calls += [(card.bf16(Cm, 2 * Ie), expert_view(dn0, e), dict(glu=True))
                 for e in range(E)]
    k4l_plain = L * cuda_ms(lambda: [k4.qgemm_grouped_plain(x, qt, **kw)
                                     for x, qt, kw in l0_calls], 1)
    k4l_lib = L * sum(yardstick_ms(card, x, qt, False) for x, qt, _ in l0_calls)
    del l0_calls
    say("k4l_times_mixtral", at_s=round(time.perf_counter() - t_path, 3),
        prompt=LLAMA_PROMPT, capacity=Cm,
        ms_per_prefill=by_kernel.get("K4L matmul", 0.0) + by_kernel.get("K4/K4L prologue", 0.0),
        matmul_ms=by_kernel.get("K4L matmul", 0.0),
        prologue_ms=by_kernel.get("K4/K4L prologue", 0.0),
        launches=launched.get("K4L matmul", 0), bound_ms_per_prefill=k4l_bound,
        plain_ms_per_prefill=k4l_plain, library_ms_per_prefill=k4l_lib,
        card=card.name, nvidia_smi=card.smi)

    k7_rows, tot = time_k7_step(card, cfg, layers)
    say("k7_times", at_s=round(time.perf_counter() - t_path, 3), rows=k7_rows,
        per_step=dict(tot, calls=2 * L), card=card.name, nvidia_smi=card.smi)

    # K4 (wqkv with its norm, wo with its residual) at decode, over the 32
    # layers, as in path 2
    k4_tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    k4_rows = []
    for shape, width in (("wqkv", H), ("wo", cfg.q_dim)):
        calls = []
        for i in range(L):
            qt = layers[i][shape]
            kw = (dict(norm=(layers[i]["attn_norm"], cfg.rms_norm_eps))
                  if shape == "wqkv" else dict(residual=card.bf16(1, qt.mdim)))
            calls.append((card.bf16(1, width), qt, kw))
        k4_rows.append(dict(shape=shape, **time_k4(card, calls)))
        for key in k4_tot:
            k4_tot[key] += L * k4_rows[-1][key]
    say("k4_times_mixtral", at_s=round(time.perf_counter() - t_path, 3),
        rows=k4_rows, per_step=dict(k4_tot, calls=2 * L))

    h_ms, h_plain, h_bound, h_lib = time_head(card, params["lm_head"])
    kv_len = LLAMA_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, cache, kv_len)
    say("k1_k2_times_mixtral", at_s=round(time.perf_counter() - t_path, 3),
        head_ms=h_ms, head_plain_ms=h_plain,
        head_bound_ms=h_bound, head_library_ms=h_lib, kv_len=kv_len,
        k2_ms=k2_ms, k2_plain_ms=k2_plain, k2_bound_ms=k2_bound,
        k2_library_ms=k2_lib, k2_per_step=L)
    bound_step = tot["bound_ms"] + k4_tot["bound_ms"] + h_bound + k2_bound * L
    say("mixtral_step", eager_ms=main["step_ms"], graph_ms=main["graph_step_ms"],
        decode_loop_ms=main["loop_ms"], kernel_bound_ms=bound_step, card=card.name,
        nvidia_smi=card.smi,
        path_s=round(time.perf_counter() - t_path, 3))
    return [
        dict(name="qgemm_experts (K7)", path="mixtral-8x7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_expert.cu",
             replaces="tmac_tpu/ops/pallas/expert_kernel.py:207",
             launches=launches["K7"], max_abs_err=k7_err,
             ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
             bound_by="bytes", library_ms=tot["library_ms"]),
        dict(name="qgemm_grouped (K4)", path="mixtral-8x7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K4"], max_abs_err=k4_err,
             ms=k4_tot["ms"], plain_ms=k4_tot["plain_ms"],
             bound_ms=k4_tot["bound_ms"], bound_by="bytes",
             library_ms=k4_tot["library_ms"]),
        dict(name="qgemm_fused (K1)", path="mixtral-8x7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=launches["K1"], max_abs_err=k1_err, ms=h_ms,
             plain_ms=h_plain, bound_ms=h_bound, bound_by="bytes",
             library_ms=h_lib),
        dict(name="flash_decode (K2)", path="mixtral-8x7b", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
             replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
             launches=launches["K2"], max_abs_err=k2_err,
             ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
             bound_by="bytes", library_ms=k2_lib * L),
    ]


# ---------------------------------------------------------------------------
# path 4: Phi-3-mini W2A16 g128, sliding window, int8 KV cache
# ---------------------------------------------------------------------------

def rand_cache(card, L, KV, S, Dl, quant):
    """A random (L, 1, KV, S, 128) cache, zero past Dl: int8 codes with
    (L, 1, KV, S) f32 scales, or bf16 values (scales None)."""
    import torch
    k = torch.randn((2, L, 1, KV, S, Dl), device=card.dev)
    pad = (0, 128 - Dl)
    if not quant:
        kv = torch.nn.functional.pad(k, pad).to(torch.bfloat16)
        return kv[0].contiguous(), kv[1].contiguous(), None, None
    from tmac_tpu_torch.ops.cuda.attention_kernel import quantize_kv
    codes, sc = quantize_kv(k)
    kv = torch.nn.functional.pad(codes, pad)
    return (kv[0].contiguous(), kv[1].contiguous(), sc[0].contiguous(),
            sc[1].contiguous())


def check_kv_modes(card, S, window, lengths):
    """K6, K8 and K9 against their plain versions on an S-row cache, bit
    for bit: Phi-3's shapes (KV 32, rep 1, head_dim 96; at split_plan's
    nsplit and at 1 and 8) and a GQA shape (KV 8, rep 4, head_dim 128),
    bf16 and int8 caches, the window and none (K6 without either is K2),
    each of `lengths` (K6 skips 0 and S).  K9
    on copies of the cache: its stored rows byte for byte the plain
    version's, every other byte untouched, and at cached length S the
    store on row S - 1, where the reference's lands.  -> (rows, worst abs
    error by kernel)."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    dev, L = card.dev, 2
    li = torch.tensor([1], dtype=torch.int32, device=dev)
    rows, worst = [], dict(K6=0.0, K8=0.0, K9=0.0)

    def same(a, b):
        return a is None or torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for KV, rep, Dl, nsplits in ((32, 1, 96, (None, 1, 8)), (8, 4, 128, (None,))):
        for quant in (True, False):
            k, v, ks, vs = rand_cache(card, L, KV, S, Dl, quant)
            q = card.bf16(1, KV, rep, Dl)
            ck, cv = card.bf16(1, KV, Dl), card.bf16(1, KV, Dl)
            kw = dict(k_scale=ks, v_scale=vs)
            for w, nsplit, n in itertools.product((window, 0), nsplits, lengths):
                kw.update(window=w, nsplit=nsplit)
                lens = torch.tensor([n], dtype=torch.int32, device=dev)
                errs = {}
                if n and n < S and (quant or w):
                    got = ak.flash_decode_split(q, k, v, lens, li, **kw)
                    want = ak.flash_decode_split_plain(q, k, v, lens, li, **kw)
                    errs["K6"] = (got, want)
                if n < S:
                    got = ak.flash_decode_append(q, k, v, lens, li, ck, cv, **kw)
                    want = ak.flash_decode_append_plain(q, k, v, lens, li, ck, cv, **kw)
                    errs["K8"] = (got, want)
                # K9 on two copies of the cache, kernel and plain
                pair = [[t.clone() if t is not None else None
                         for t in (k, v, ks, vs)] for _ in range(2)]
                outs = []
                for fn, (kk, vv, kks, vvs) in zip(
                        (ak.flash_decode_append_write,
                         ak.flash_decode_append_write_plain), pair):
                    outs.append(fn(q, kk, vv, lens, li, ck, cv, k_scale=kks,
                                   v_scale=vvs, window=w, nsplit=nsplit))
                errs["K9"] = tuple(outs)
                torch.cuda.synchronize()
                stored = all(same(a, b) for a, b in zip(*pair))
                # outside row min(n, S - 1) of layer 1 the cache is as
                # it was
                untouched = True
                for t, new in zip((k, v, ks, vs), pair[0]):
                    if t is None:
                        continue
                    diff = (t != new).reshape(L, 1, KV, S, -1).any(-1)
                    diff[1, 0, :, min(n, S - 1)] = False
                    untouched &= not bool(diff.any())
                row = dict(KV=KV, rep=rep, Dl=Dl, cache="int8" if quant else "bf16",
                           window=w, nsplit=nsplit, len=n, stored_equal=stored,
                           rest_untouched=untouched)
                for name, (got, want) in errs.items():
                    err = float((got.float() - want.float()).abs().max())
                    worst[name] = max(worst[name], err)
                    row[name] = dict(max_abs_err=err,
                                     bitwise=bool(torch.equal(got, want)))
                rows.append(row)
                if not (stored and untouched and all(
                        r["bitwise"] for n_, r in row.items() if n_ in errs)):
                    raise AssertionError(f"K6/K8/K9 check failed: {row}")
    return rows, worst


def llama_in_mode(cfg, params, mode, plain=False, block=False):
    """Llama with its decode KV-write mode and block mode chosen as a user
    chooses them: the deferred_kv argument, or TMAC_KV_INKERNEL=1 and
    TMAC_BLOCK_KERNEL=1 in the environment while the model is made (the
    modes are resolved once, there)."""
    import os
    from tmac_tpu_torch.models.llama import Llama
    names = ("TMAC_KV_INKERNEL", "TMAC_DEFERRED_KV", "TMAC_BLOCK_KERNEL")
    saved = {n: os.environ.pop(n, None) for n in names}
    try:
        if mode == "inkernel":
            os.environ["TMAC_KV_INKERNEL"] = "1"
        if block:
            os.environ["TMAC_BLOCK_KERNEL"] = "1"
        model = Llama(cfg, params, plain=plain,
                      deferred_kv=True if mode == "deferred" else None)
    finally:
        for n in names:
            os.environ.pop(n, None)
        os.environ.update({n: v for n, v in saved.items() if v is not None})
    if model.kv_mode != mode or model.block_mode != block:
        raise AssertionError(f"asked for the {mode} mode (block {block}), got "
                             f"{model.kv_mode} (block {model.block_mode})")
    return model


def noise_gated_argmax(ref, got, ref64):
    """Argmax agreement of got (P, V) with the f32 plain path's ref where
    ref's top token leads its runner-up by more than NOISE_LEADS times the
    per-logit rms |ref - ref64| of that position (ref64: the plain path in
    another sum order) and by TIE_MARGIN at least: a dict of the share of
    positions gated, the agreement over them (1.0 when none is gated) and
    the median margin."""
    import torch
    ref, got, ref64 = (t.float().reshape(-1, t.shape[-1]) for t in (ref, got, ref64))
    noise = (ref - ref64).pow(2).mean(-1).sqrt()
    top2 = ref.topk(2, dim=-1).values
    margin = (NOISE_LEADS * noise).clamp_min(TIE_MARGIN)
    gated = (top2[:, 0] - top2[:, 1]) > margin
    agree = got.argmax(-1) == ref.argmax(-1)
    return dict(gated_share=float(gated.float().mean()),
                gated_agreement=float(agree[gated].float().mean()) if bool(gated.any())
                else 1.0,
                agreement=float(agree.float().mean()),
                median_margin=float(margin.median()))


def llama_shallow_check(card, cfg, params, prompt_len, chunk):
    """The teacher-forced check of llama_path's prefill at Llama-2-7B's
    full width with only its first LLAMA_SHALLOW_LAYERS layers, where the
    sum order alone drifts the logits by ~1e-4: the prompt in `chunk`-token
    pieces through the kernels (K5 on 4 linears a layer, K3 on the head),
    the plain versions and the plain versions with K5's matmul summed in
    float64; the logits of every position held to noise_gated_argmax
    (at least SHALLOW_GATED_SHARE of them gated), their NMSE to
    SHALLOW_NMSE and to LLAMA_FLOOR_RATIO times the f32 - f64 drift."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.utils import nmse
    L = LLAMA_SHALLOW_LAYERS
    cfg2 = dataclasses.replace(cfg, num_layers=L)
    params2 = dict(params, layers=params["layers"][:L])
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, prompt_len))
    tokens = torch.from_numpy(prompt).to(card.dev)

    def all_logits(model):
        cache, out = KVCache.create(cfg2, 1, prompt_len, device=card.dev), []
        with torch.no_grad():
            for off in range(0, prompt_len, chunk):
                logits, cache = model(tokens[:, off:off + chunk], cache)
                out.append(logits[0].float())
        return torch.cat(out)
    t0 = time.perf_counter()
    zero_counts()
    got = all_logits(llama_in_mode(cfg2, params2, "explicit"))
    torch.cuda.synchronize()
    launches = read_counts()
    ref = all_logits(llama_in_mode(cfg2, params2, "explicit", plain=True))
    with f64_dequant_plain():
        ref64 = all_logits(llama_in_mode(cfg2, params2, "explicit", plain=True))
    chunks = prompt_len // chunk
    want = counts(K3=chunks, K5=4 * L * chunks)
    r, g, r64 = (t.cpu().numpy() for t in (ref, got, ref64))
    row = dict(layers=L, positions=prompt_len, nmse=nmse(r, g),
               plain_f32_vs_f64_nmse=nmse(r, r64), kernel_vs_f64_nmse=nmse(r64, g),
               nmse_gate=SHALLOW_NMSE, **noise_gated_argmax(ref, got, ref64),
               last_argmax_agreement=float(got[-1].argmax() == ref[-1].argmax()),
               # how often the sum order alone moves an argmax: the f64
               # plain path against the f32 one, and K5 against the f64 one
               plain_f32_vs_f64_agreement=float(
                   (ref64.argmax(-1) == ref.argmax(-1)).float().mean()),
               kernel_vs_f64_agreement=float((got.argmax(-1) == ref64.argmax(-1))
                                             .float().mean()),
               finite=bool(torch.isfinite(got).all()), launches=launches,
               seconds=round(time.perf_counter() - t0, 3))
    row["floor_gate"] = LLAMA_FLOOR_RATIO * row["plain_f32_vs_f64_nmse"]
    say("llama_shallow_teacher_forced", **row)
    if not (row["finite"] and launches == want and row["nmse"] <= SHALLOW_NMSE
            and row["nmse"] <= row["floor_gate"] and row["gated_agreement"] == 1.0
            and row["gated_share"] >= SHALLOW_GATED_SHARE):
        raise AssertionError(f"llama shallow teacher-forced: {row} (launches wanted {want})")


@contextlib.contextmanager
def f64_dequant_plain():
    """K5's plain version with its matmul summed in float64, then rounded
    to float32: the plain path in another summation order."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k5
    saved = k5.qgemm_dequant_plain

    def plain64(x, qt, norm=None, glu=False, residual=None):
        out = (k5.act_bf16_plain(x, qt, norm, glu).double()
               @ k5.dequant_weights_plain(qt).double()).float()
        if residual is not None:
            out = out + residual.float()
        return qt.slice_m(out)
    k5.qgemm_dequant_plain = plain64
    try:
        yield
    finally:
        k5.qgemm_dequant_plain = saved


def clone_cache(cache):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache) if getattr(cache, f.name) is not None})


def cache_bytes_equal(a, b):
    import torch
    return all((x is None and y is None) or torch.equal(
        x.view(torch.uint8), y.view(torch.uint8))
        for x, y in ((a.k, b.k), (a.v, b.v), (a.pos, b.pos),
                     (a.k_scale, b.k_scale), (a.v_scale, b.v_scale)))


def time_kv_modes(card, cfg, caches, n):
    """K6 (int8 and bf16 caches), K8 and K9 per call over the path's caches
    at n cached rows, window 2047 (CUDA graphs of one call a layer, the
    rows cold in L2): ms, plain ms, byte bound and SDPA on a dequantized
    bf16 copy of the same rows; K6 on int8 also at 64 and 128 rows a block.
    -> {label: dict}."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    dev, L, Dl, W = card.dev, cfg.num_layers, cfg.head_dim, cfg.sliding_window
    KVh, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = card.bf16(1, KVh, rep, Dl)
    ck, cv = card.bf16(1, KVh, Dl), card.bf16(1, KVh, Dl)
    lens = torch.tensor([n], dtype=torch.int32, device=dev)
    lis = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    out = {}
    for label, fn, plain, cache, cur in (
            ("K6 int8", ak.flash_decode_split, ak.flash_decode_split_plain,
             caches["int8"], False),
            ("K6 bf16", ak.flash_decode_split, ak.flash_decode_split_plain,
             caches["bf16"], False),
            ("K8 int8", ak.flash_decode_append, ak.flash_decode_append_plain,
             caches["int8"], True),
            ("K9 int8", ak.flash_decode_append_write,
             ak.flash_decode_append_write_plain, caches["scratch"], True)):
        kw = dict(k_scale=cache.k_scale, v_scale=cache.v_scale, window=W)
        extra = (ck, cv) if cur else ()
        ms = graph_ms(lambda: [fn(q, cache.k, cache.v, lens, i, *extra, **kw)
                               for i in lis]) / L
        plain_ms = cuda_ms(lambda: plain(q, cache.k, cache.v, lens, lis[1],
                                         *extra, **kw), 3)
        # the windowed rows the function reads (K8 and K9: the cached ones
        # below n, then the current token as an operand), each k and v row
        # at Dl columns and its two scales once; q, the output, the
        # current k/v and K9's stored rows
        lo = max(n - W + (1 if cur else 0), 0)
        rows = n - lo
        item = cache.k.element_size()
        nbytes = (2 * KVh * rows * (Dl * item + (4 if cache.quantized else 0))
                  + 2 * q.numel() * 2 + (2 * KVh * Dl * 2 if cur else 0)
                  + (2 * KVh * (128 * item + 4) if fn is ak.flash_decode_append_write else 0))
        ops = 4 * KVh * rep * (rows + (1 if cur else 0)) * Dl
        peak = card.int8_peak if cache.quantized else card.bf16_peak
        out[label] = dict(rows=rows + (1 if cur else 0), ms=ms, plain_ms=plain_ms,
                          bound_ms=card.bound_ms(nbytes, ops, peak),
                          bound_by="bytes" if nbytes / card.bw >= ops / peak
                          else "operations", bytes=nbytes)
    # the yardstick: SDPA over the same 2047 rows of each layer, dequantized
    # to bf16 beforehand (K6 at n rows and K8/K9 at n cached rows plus the
    # current one attend over as many)
    c8, lo = caches["int8"], max(n - W, 0)
    views = []
    for i in range(L):
        kk = (c8.k[i, :, :, lo:n, :Dl].float() * c8.k_scale[i, :, :, lo:n, None])
        vv = (c8.v[i, :, :, lo:n, :Dl].float() * c8.v_scale[i, :, :, lo:n, None])
        views.append((kk.to(torch.bfloat16), vv.to(torch.bfloat16)))
    qs = q.reshape(1, KVh * rep, 1, Dl)
    gqa = dict(enable_gqa=True) if rep > 1 else {}
    lib = graph_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv, **gqa) for kk, vv in views]) / L
    for row in out.values():
        row["library_ms"] = lib
    # K6 on the int8 cache at cluster sizes around split_plan's (12 and 16,
    # non-portable clusters, where the card schedules them)
    kw = dict(k_scale=c8.k_scale, v_scale=c8.v_scale, window=W)
    by_nsplit = {}
    for p in (1, 2, 3, 4, 6, 8, 12, 16):
        try:
            by_nsplit[p] = graph_ms(lambda: [ak.flash_decode_split(
                q, c8.k, c8.v, lens, i, nsplit=p, **kw) for i in lis]) / L
        except RuntimeError as e:
            if p <= 8:
                raise
            by_nsplit[p] = f"refused: {e}"
    out["K6 int8"]["ms_by_nsplit"] = by_nsplit
    out["K6 int8"]["nsplit"] = ak.split_plan(1, KVh, min(c8.k.shape[3], W),
                                             ak.sm_count(dev))
    return out


# The decode-matmul sweep's rows, and its shapes: (label, K, M, bits, group
# size (0: per-tensor), folds) of K1 on BitNet-3B and K4 on Llama-2-7B W2
# (down at its padded K, silu(g) * u before it), Phi-3-mini W2 and
# Mixtral-8x7B W2 (attention, and the experts' shapes its dispatch prefill
# reaches at small N)
QGEMM_SWEEP_ROWS = (1, 4, 16)
K1_SWEEP_SHAPES = (("bitnet wqkv", 3200, 9600, 2, 0, "norm"),
                   ("bitnet wo", 3200, 3200, 2, 0, "residual"),
                   ("bitnet gate_up", 3200, 17280, 2, 0, "norm"),
                   ("bitnet down", 8704, 3200, 2, 0, "glu residual"),
                   ("bitnet head", 3200, 32000, 8, 0, ""))
K4_SWEEP_SHAPES = (("llama wqkv", 4096, 12288, 2, 128, "norm"),
                   ("llama wo", 4096, 4096, 2, 128, "residual"),
                   ("llama gate_up", 4096, 22016, 2, 128, "norm"),
                   ("llama down", 11264, 4096, 2, 128, "residual"),
                   ("phi3 wqkv", 3072, 9216, 2, 128, "norm"),
                   ("phi3 wo", 3072, 3072, 2, 128, "residual"),
                   ("phi3 gate_up", 3072, 16384, 2, 128, "norm"),
                   ("phi3 down", 8192, 3072, 2, 128, "glu residual"),
                   ("mixtral wqkv", 4096, 6144, 2, 128, "norm"),
                   ("mixtral wo", 4096, 4096, 2, 128, "residual"),
                   ("mixtral expert gate_up", 4096, 28672, 2, 128, ""),
                   ("mixtral expert down", 14336, 4096, 2, 128, "glu"))
# K4's bits 3 and 1 forms at Llama-3.1-8B's shapes (each row also checked
# against the plain version), and Qwen2-7B's at bits 4
B13_SHAPES = (("wqkv", 4096, 6144, "norm"), ("wo", 4096, 4096, "residual"),
              ("gate_up", 4096, 28672, "norm"), ("down", 14336, 4096, "glu residual"))
K4_B13_SWEEP_SHAPES = tuple((f"llama31 {label} w{bits}", K, M, bits, 128, folds)
                            for bits in (3, 1) for label, K, M, folds in B13_SHAPES) + (
    ("qwen2 wqkv", 3584, 4608, 4, 128, "norm"), ("qwen2 wo", 3584, 3584, 4, 128, "residual"),
    ("qwen2 gate_up", 3584, 37888, 4, 128, "norm"),
    ("qwen2 down", 18944, 3584, 4, 128, "glu residual"))


def ternary_qt_on_card(gen, K, M, dev):
    """Per-tensor 2-bit weights (K, M) drawn on the card (random packed
    bytes, f32 scales ~1/sqrt(K), sub = 2 * scale), K padded to a multiple
    of 16 as the package pads it."""
    import torch
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    from tmac_tpu_torch.utils import round_up
    Kp = round_up(K, 16)
    packed = torch.randint(0, 256, (Kp // 4, M), generator=gen, device=dev,
                           dtype=torch.uint8)
    scales = (0.5 + torch.rand((1, M), generator=gen, device=dev)) / math.sqrt(K)
    return QuantizedTensor(packed, None, scales, 2 * scales, 2, Kp, 1, 1, (K, M))


def qgemm_decode_sweep(card, layers=8):
    """K1 and K4 per call at QGEMM_SWEEP_ROWS rows on K1_SWEEP_SHAPES and
    K4_SWEEP_SHAPES, through their wrappers (qgemm_fused, qgemm_grouped)
    with each shape's folds: a CUDA graph of calls over at least `layers`
    copies of the weights, as many as pass 120 MB (cold in the 50 MB L2,
    as in a decode step), beside the byte bound and the bf16 matmul
    yardstick, and the cluster size decode_plan gives (None where the
    package has no decode_plan).  -> rows"""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    plan = getattr(k1, "decode_plan", None)
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(8)
    out = []
    # the shapes added with bits 1 and 3 (and rows past 16384), which a
    # parent package for an A/B does not take
    new_shapes = K4_B13_SWEEP_SHAPES if hasattr(k4, "GROUPED_BITS") else ()
    for kernel, fn, shapes in (("K1", k1.qgemm_fused, K1_SWEEP_SHAPES),
                               ("K4", k4.qgemm_grouped, K4_SWEEP_SHAPES + new_shapes)):
        for label, K, M, bits, gs, folds in shapes:
            if gs:
                one = rand_qt_on_card(gen, K, M, bits, gs, card.dev)
            elif bits == 8:
                one = int8_head_on_card(gen, K, M, card.dev)
            else:
                one = ternary_qt_on_card(gen, K, M, card.dev)
            wbytes = one.packed.numel() + 2 * one.scales.numel() * one.scales.element_size()
            ws = [one] + [dataclasses.replace(one, packed=one.packed.clone())
                          for _ in range(max(layers, math.ceil(120e6 / wbytes)) - 1)]
            ones = torch.ones(K, dtype=torch.bfloat16, device=card.dev)
            for N in QGEMM_SWEEP_ROWS:
                kw = {}
                if "norm" in folds:
                    kw["norm"] = (ones, 1e-5)
                if "residual" in folds:
                    kw["residual"] = card.bf16(N, M)
                kw["glu"] = "glu" in folds
                x = card.bf16(N, 2 * K if kw["glu"] else K)
                us = graph_ms(lambda: [fn(x, w, **kw) for w in ws]) / len(ws) * 1e3
                Kp, Mp = one.kdim_padded, one.mdim_padded
                out.append(dict(
                    kernel=kernel, shape=label, N=N, K=Kp, Mp=Mp, bits=bits, us=us,
                    bound_us=card.bound_ms(qgemm_bytes(one, x, kw), 2 * N * Kp * Mp,
                                           card.int8_peak) * 1e3,
                    bf16_us=yardstick_ms(card, x, one, True) * 1e3,
                    ksplit=plan(N, Kp, Mp, bits, gs)[0] if plan else None))
                if (label, K, M, bits, gs, folds) in new_shapes:
                    # against the plain version: bit for bit without the
                    # folds, within FOLDED_NMSE with them (check_k4)
                    rows, _ = check_k4(card, [(label, x, one, kw),
                                              (label, card.bf16(N, K), one, {})], (None,))
                    out[-1]["checks"] = [dict(folds=r["folds"], bitwise=r["bitwise"],
                                              nmse=r["nmse"]) for r in rows]
            del ws
    torch.cuda.empty_cache()
    return out


def decode_plan_sweep(card, layers=8):
    """K1 and K4 per call at every cluster size of qgemm_kernel.DECODE_SPLITS
    (forced after the prologue, decode_split_call) on K1_SWEEP_SHAPES and
    K4_SWEEP_SHAPES at QGEMM_SWEEP_ROWS rows, timed as qgemm_decode_sweep
    times them, beside decode_plan's choice: the data decode_plan's
    constants are fitted to.  A size whose shared memory cannot fit is
    None.  -> rows"""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(8)
    out = []
    for shapes in (K1_SWEEP_SHAPES, K4_SWEEP_SHAPES):
        for label, K, M, bits, gs, folds in shapes:
            if gs:
                one = rand_qt_on_card(gen, K, M, bits, gs, card.dev)
            elif bits == 8:
                one = int8_head_on_card(gen, K, M, card.dev)
            else:
                one = ternary_qt_on_card(gen, K, M, card.dev)
            ws = [one] + [dataclasses.replace(one, packed=one.packed.clone())
                          for _ in range(max(layers, math.ceil(120e6 / one.packed.numel())) - 1)]
            ones = torch.ones(K, dtype=torch.bfloat16, device=card.dev)
            for N in QGEMM_SWEEP_ROWS:
                kw = {"glu": "glu" in folds}
                if "norm" in folds:
                    kw["norm"] = (ones, 1e-5)
                if "residual" in folds:
                    kw["residual"] = card.bf16(N, M)
                x = card.bf16(N, 2 * K if kw["glu"] else K)
                us = {}
                for ksplit in k1.DECODE_SPLITS:
                    try:
                        us[ksplit] = graph_ms(lambda: [decode_split_call(x, w, kw, ksplit)
                                                       for w in ws]) / len(ws) * 1e3
                    except ValueError:
                        us[ksplit] = None
                plan = k1.decode_plan(N, one.kdim_padded, M, bits, gs, card.sms)[0]
                out.append(dict(shape=label, N=N, plan=plan, us=us))
            del ws
    torch.cuda.empty_cache()
    return out


# K3's sweep: BitNet-3B's five prefill shapes with their folds and
# Llama-2-7B's int8 head (label, K, M, bits, folds), at K3_SWEEP_ROWS rows
K3_SWEEP_ROWS = (64, 256, 1024)
K3_SWEEP_SHAPES = (("bitnet wqkv", 3200, 9600, 2, "norm"),
                   ("bitnet wo", 3200, 3200, 2, "residual"),
                   ("bitnet gate_up", 3200, 17280, 2, "norm"),
                   ("bitnet down", 8640, 3200, 2, "glu residual"),
                   ("bitnet head", 3200, 32002, 8, ""),
                   ("llama head", 4096, 32000, 8, ""))


def k3_split_call(x, qt, kw, tile=None, ksplit=None):
    """K3's function on the card at a forced tile (token rows, columns) and
    cluster size (None: large_plan's): the prologue, then the matmul."""
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    codes, xs, xsum = k1.launch_act_quant(x, qt, kw.get("norm"), kw.get("glu", False),
                                          large_n=True)
    return qt.slice_m(k1.launch_large_int(codes, xs, xsum, qt, kw.get("residual"),
                                          ksplit=ksplit, tile=tile))


def k3_sweep(card, layers=4):
    """K3 per call at K3_SWEEP_SHAPES x K3_SWEEP_ROWS through its wrapper
    (qgemm_large_int, prologue and matmul) with each shape's folds: a CUDA
    graph of calls over `layers` copies of the weights, cold in L2 as a
    prefill finds them, beside the bound (int8 operations or bytes), the
    same function as one PyTorch call (torch._int_mm on the unpacked int8
    codes, the second operand row-major (Kp, Mp) and column-major: the
    transpose of a contiguous (Mp, Kp) copy; the faster one is the
    yardstick) and a bf16 matmul on the dequantized weights.  With
    large_plan (the wgmma design): the plan's (token rows, columns, cluster
    size) and every configuration's time, the data large_plan is held to.  Runs on the
    package before it too.  -> rows"""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.ops.qgemm import unpack_codes
    plan = getattr(k1, "large_plan", None)
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(11)
    rows = []
    for label, K, M, bits, folds in K3_SWEEP_SHAPES:
        one = (int8_head_on_card(gen, K, M, card.dev) if bits == 8
               else ternary_qt_on_card(gen, K, M, card.dev))
        ws = [one] + [dataclasses.replace(one, packed=one.packed.clone())
                      for _ in range(layers - 1)]
        Kp, Mp = one.kdim_padded, one.mdim_padded
        w8 = unpack_codes(one).contiguous()
        row_major = [w8] + [w8.clone() for _ in range(layers - 1)]
        col_major = [w8.t().contiguous().t() for _ in range(layers)]
        del w8
        ones = torch.ones(K, dtype=torch.bfloat16, device=card.dev)
        for N in K3_SWEEP_ROWS:
            kw = {"glu": "glu" in folds}
            if "norm" in folds:
                kw["norm"] = (ones, 1e-5)
            if "residual" in folds:
                kw["residual"] = card.bf16(N, M)
            x = card.bf16(N, 2 * K if kw["glu"] else K)
            codes = torch.randint(-127, 128, (N, Kp), dtype=torch.int8, device=card.dev)
            ops, nbytes = 2 * N * Kp * Mp, qgemm_bytes(one, x, kw)
            row = dict(
                shape=label, N=N, K=Kp, Mp=Mp, bits=bits,
                us=graph_ms(lambda: [k1.qgemm_large_int(x, w, **kw) for w in ws],
                            reps=5) / layers * 1e3,
                bound_us=card.bound_ms(nbytes, ops, card.int8_peak) * 1e3,
                bound_by="bytes" if nbytes / card.bw >= ops / card.int8_peak
                else "operations",
                int_mm_row_major_us=graph_ms(lambda: [torch._int_mm(codes, w)
                                                      for w in row_major], reps=5)
                / layers * 1e3,
                int_mm_col_major_us=graph_ms(lambda: [torch._int_mm(codes, w)
                                                      for w in col_major], reps=5)
                / layers * 1e3,
                bf16_us=yardstick_ms(card, x, one, False) * 1e3)
            row["library_us"] = min(row["int_mm_row_major_us"], row["int_mm_col_major_us"])
            if plan:
                row["plan"] = plan(N, Kp, Mp, bits, card.sms)
                row["us_by_tile_split"] = {
                    f"{bm}x{bn}x{ks}": graph_ms(lambda: [k3_split_call(x, w, kw, (bm, bn), ks)
                                                        for w in ws], reps=5) / layers * 1e3
                    for bm, bn in k1.LARGE_TILES
                    if bm <= 2 * N and 8 * bm >= N and (bits == 2 or bn == 128)
                    for ks in range(1, k1.LARGE_MAX_SPLIT + 1)}
            rows.append(row)
        del ws, row_major, col_major
        torch.cuda.empty_cache()
    return rows


def expert_block_sweep(card, calls=8):
    """K7 at Mixtral-8x7B's expert shapes (W2 g128: gate_up 4096 x 28672,
    down 14336 x 4096 with the SwiGLU prologue) and K10 at BitNet-3B's
    layer shapes, per call: CUDA graphs of `calls` calls over distinct
    weights (two 8-expert stacks, each call routed to other experts; 8
    BitNet layers), cold in the 50 MB L2 as in a decode step, beside the
    byte bound and the yardstick (K7: the bf16 matmul on each routed
    expert's dequantized weights; K10: K1's three calls).  K7 per expert
    (k = 1) and for a layer's two routed experts, gate_up, down and both
    as the select form runs them, at N = 1 and 4.  Runs on the package
    before K7's k-expert form too (no qgemm_experts: two qgemm_expert calls
    each, and the layer casts gate_up's output to bf16 between, as that
    select form did).  With the k-expert form: K7's and K10's checks
    first, and K7's two-expert calls at every cluster size beside
    decode_plan's.  -> dict"""
    import torch
    from tmac_tpu_torch.models.moe import expert_view, stack_experts
    from tmac_tpu_torch.ops.cuda import block_kernel as k10
    from tmac_tpu_torch.ops.cuda import expert_kernel as k7
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    from tmac_tpu_torch.ops.qgemm import fuse_m
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(10)
    H, Ie, E, k, dev = 4096, 14336, 8, 2, card.dev
    new = hasattr(k7, "qgemm_experts")
    stacks = [(stack_experts([fuse_m([rand_qt_on_card(gen, H, Ie, 2, 128, dev)
                                      for _ in range(2)]) for _ in range(E)]),
               stack_experts([rand_qt_on_card(gen, Ie, H, 2, 128, dev) for _ in range(E)]))
              for _ in range(2)]
    routes = [(i % 2, [(i // 2 * k + j) % E for j in range(k)]) for i in range(calls)]
    idx = [torch.tensor(r, dtype=torch.int32, device=dev) for _, r in routes]
    out = dict(new_form=new, card=card.name, nvidia_smi=card.smi)
    if new:
        gc = [("gate_up", card.bf16(1, N, H), stacks[0][0], False) for N in (1, 4)]
        dc = [("down", card.bf16(E, N, 2 * Ie).float(), stacks[0][1], True) for N in (1, 4)]
        out["k7_checks"] = check_k7(card, gc + dc)[0]
    one_gu, one_dn = expert_view(stacks[0][0], 0), expert_view(stacks[0][1], 0)
    rows = []
    for N in (1, 4):
        x, xd = card.bf16(N, H), card.bf16(k, N, 2 * Ie)
        xdf = xd.float()  # each expert's gate_up output, as the select form gives it

        def st(i, w):
            return stacks[routes[i][0]][w]

        def gu1(i):
            k7.qgemm_expert(x, st(i, 0), idx[i][:1])

        def dn1(i):
            k7.qgemm_expert(xd[0], st(i, 1), idx[i][:1], glu=True)
        if new:
            def gu2(i):
                k7.qgemm_experts(x, st(i, 0), idx[i])

            def dn2(i):
                k7.qgemm_experts(xdf, st(i, 1), idx[i], glu=True)

            def layer(i):
                g = k7.qgemm_experts(x, st(i, 0), idx[i])
                k7.qgemm_experts(g.contiguous(), st(i, 1), idx[i], glu=True)
        else:
            def gu2(i):
                for j in range(k):
                    k7.qgemm_expert(x, st(i, 0), idx[i][j:j + 1])

            def dn2(i):
                for j in range(k):
                    k7.qgemm_expert(xd[j], st(i, 1), idx[i][j:j + 1], glu=True)

            def layer(i):
                for j in range(k):
                    g = k7.qgemm_expert(x, st(i, 0), idx[i][j:j + 1])
                    k7.qgemm_expert(g.to(torch.bfloat16), st(i, 1), idx[i][j:j + 1], glu=True)
        b_gu1 = card.bound_ms(expert_bytes(one_gu, 1, x), 2 * N * H * 2 * Ie, card.int8_peak)
        b_dn1 = card.bound_ms(expert_bytes(one_dn, 1, xd[0]), 2 * N * H * Ie, card.int8_peak)
        b_gu2 = card.bound_ms(expert_bytes(one_gu, k, x), 2 * k * N * H * 2 * Ie,
                              card.int8_peak)
        b_dn2 = card.bound_ms(expert_bytes(one_dn, k, xd), 2 * k * N * H * Ie, card.int8_peak)
        lib_gu = yardstick_ms(card, x, one_gu, True)
        lib_dn = yardstick_ms(card, xd[0], one_dn, True)
        for label, fn, experts, bound, lib in (
                ("gate_up", gu1, 1, b_gu1, lib_gu), ("down", dn1, 1, b_dn1, lib_dn),
                ("gate_up", gu2, k, b_gu2, k * lib_gu), ("down", dn2, k, b_dn2, k * lib_dn),
                ("layer", layer, k, b_gu2 + b_dn2, k * (lib_gu + lib_dn))):
            us = graph_ms(lambda: [fn(i) for i in range(calls)]) / calls * 1e3
            row = dict(shape=label, N=N, experts=experts, us=us, bound_us=bound * 1e3,
                       bf16_us=lib * 1e3)
            if new and label != "layer":
                K, Mp = (H, 2 * Ie) if label == "gate_up" else (Ie, H)
                row["ksplit"], row["nt"], row["stages"] = k1.decode_plan(
                    N, K, Mp, 2, 128, card.sms, experts)
                if experts == k:
                    xi, w = (x, 0) if label == "gate_up" else (xdf, 1)
                    row["us_by_ksplit"] = {}
                    for ks in k1.DECODE_SPLITS:
                        try:
                            row["us_by_ksplit"][ks] = graph_ms(lambda: [
                                k7.launch_experts(xi, st(i, w), idx[i], w == 1, ks)
                                for i in range(calls)]) / calls * 1e3
                        except ValueError:
                            row["us_by_ksplit"][ks] = None
            rows.append(row)
    out["k7"] = rows
    del stacks
    torch.cuda.empty_cache()

    # K10 at BitNet-3B's layer shapes (wo 3200 x 3200, gate_up 3200 x 17280,
    # down 8640 x 3200), per-tensor W2
    blocks = [(card.bf16(1, 3200), card.bf16(1, 3200),
               (1.0 + 0.1 * card.bf16(3200)).to(torch.bfloat16),
               ternary_qt_on_card(gen, 3200, 3200, dev),
               ternary_qt_on_card(gen, 3200, 17280, dev),
               ternary_qt_on_card(gen, 8640, 3200, dev), 1e-5) for _ in range(calls)]
    if hasattr(k10, "block_plan"):
        out["k10_checks"] = check_k10(card, [(f"layer {i}", blocks[i]) for i in (0, 1)])[0]
    out["k10"] = time_k10(card, blocks)
    del blocks
    torch.cuda.empty_cache()
    return out


def pdl_overlap(card, calls=4):
    """The programmatic dependent launch seen on the card: torch.profiler's
    trace of `calls` K1 calls (BitNet-3B's down, N = 1), K4 calls
    (Llama-2-7B W2's down) and K3 calls (BitNet-3B's wo at a 256-row
    prefill chunk), eagerly and replayed from a CUDA graph; for each matmul
    kernel, how far it started before its prologue ended (µs, positive:
    they overlap).  -> {mode: summary}"""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(9)
    w1 = ternary_qt_on_card(gen, 8704, 3200, card.dev)
    w4 = rand_qt_on_card(gen, 11264, 4096, 2, 128, card.dev)
    w3 = ternary_qt_on_card(gen, 3200, 3200, card.dev)
    x1, x4, x3 = card.bf16(1, 2 * 8704), card.bf16(1, 11264), card.bf16(256, 3200)
    r1, r4, r3 = card.bf16(1, 3200), card.bf16(1, 4096), card.bf16(256, 3200)

    def fn():
        for _ in range(calls):
            k1.qgemm_fused(x1, w1, glu=True, residual=r1)
            k4.qgemm_grouped(x4, w4, residual=r4)
            k1.qgemm_large_int(x3, w3, residual=r3)

    def trace(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(path)
        kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                         if e.get("cat") == "kernel")
        out = {}
        for label, pro, mm in (("K1", "act_quant_kernel", "k1_decode_kernel"),
                               ("K4", "act_quant_grouped_kernel", "k4_decode_kernel"),
                               ("K3", "act_quant_kernel", "k3_wgmma_kernel")):
            leads, last_end = [], None
            for start, end, name in kernels:
                if pro in name:
                    last_end = end
                elif mm in name and last_end is not None:
                    leads.append(last_end - start)
                    last_end = None
            out[label] = dict(pairs=len(leads), overlapping=sum(x > 0 for x in leads),
                              lead_us=leads)
        out["kernels_seen"] = len(kernels)
        return out
    eager = trace(fn)
    graph = capture(fn)
    replayed = trace(graph.replay)
    del graph
    return dict(eager=eager, graph=replayed)


# The attention sweep's rows, and its head shapes: (label, KV heads, query
# heads per KV head, head_dim, int8 cache, window), those K2 and K6 serve
# on the paths (BitNet, Llama, Mixtral; Phi-3 on each cache)
ATTN_SWEEP_ROWS = (1, 64, 288, 1056, 2047)
ATTN_SWEEP_SHAPES = (("bitnet", 32, 1, 100, False, 0),
                     ("llama", 32, 1, 128, False, 0),
                     ("mixtral", 8, 4, 128, False, 0),
                     ("phi3 int8", 32, 1, 96, True, 2047),
                     ("phi3 bf16", 32, 1, 96, False, 2047))


def attn_sweep(card, layers=8, S=2048):
    """Decode attention per call (K2; K6 with Phi-3's window) at each of
    ATTN_SWEEP_ROWS valid rows and ATTN_SWEEP_SHAPES, over a `layers`-layer
    S-row random cache (a CUDA graph of one call a layer; the layers' rows
    pass the 50 MB L2 from ~300 rows on), beside SDPA over the same rows
    (bf16; dequantized beforehand for the int8 cache) and the byte bound
    (each row's Dl columns of k and v and its two scales once, q and the
    output).  The 1-row time is the fixed cost of a call; the rest is
    streaming.  -> rows"""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    dev, out = card.dev, []
    lis = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(layers)]
    for label, KV, rep, Dl, quant, W in ATTN_SWEEP_SHAPES:
        k, v, ks, vs = rand_cache(card, layers, KV, S, Dl, quant)
        q = card.bf16(1, KV, rep, Dl)
        qs = q.reshape(1, KV * rep, 1, Dl)
        gqa = dict(enable_gqa=True) if rep > 1 else {}
        kw = dict(k_scale=ks, v_scale=vs, window=W)
        for n in ATTN_SWEEP_ROWS:
            lens = torch.tensor([n], dtype=torch.int32, device=dev)
            ms = graph_ms(lambda: [ak.flash_decode(q, k, v, lens, i, **kw)
                                   for i in lis]) / layers
            lo = max(n - W, 0) if W else 0
            views = []
            for i in range(layers):
                kk, vv = k[i, :, :, lo:n, :Dl], v[i, :, :, lo:n, :Dl]
                if quant:
                    kk = (kk.float() * ks[i, :, :, lo:n, None]).to(torch.bfloat16)
                    vv = (vv.float() * vs[i, :, :, lo:n, None]).to(torch.bfloat16)
                views.append((kk, vv))
            lib = graph_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
                qs, kk, vv, **gqa) for kk, vv in views]) / layers
            rows = n - lo
            nbytes = (2 * KV * rows * (Dl * k.element_size() + (4 if quant else 0))
                      + 2 * q.numel() * 2)
            ops = 4 * KV * rep * rows * Dl
            peak = card.int8_peak if quant else card.bf16_peak
            out.append(dict(shape=label, rows=rows, us=ms * 1e3, sdpa_us=lib * 1e3,
                            bound_us=card.bound_ms(nbytes, ops, peak) * 1e3))
            del views
        del k, v, ks, vs
    return out


def check_kv_bounds(card, cfg, params, prompt):
    """Writes at the cache's last row, on a cache of 128 rows: a slot held
    at pos == S (as the reference's engine holds an inactive one) decodes a
    step in each KV-write mode, and a 16-token chunk is prefilled from pos
    S - 6, on int8 and bf16 caches; the cache rows S - 1 (the step) and
    S - 16 .. S - 1 (the chunk) are written, as the reference's clamped
    writes put them, with no device-side assert, and kernel and plain paths
    agree (cache bytes equal, logits within PATH_NMSE).  Then one more
    kernel runs, to show that the context is still usable."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.utils import nmse
    S, dev, rows = 128, card.dev, []
    P = prompt.shape[1]
    for quant in (True, False):
        for mode, T, pos in (("explicit", 1, S), ("deferred", 1, S), ("inkernel", 1, S),
                             ("explicit", 16, S - 6)):
            out = []
            for plain in (False, True):
                model = llama_in_mode(cfg, params, mode, plain=plain)
                cache = KVCache.create(cfg, 1, S, device=dev, quant=quant)
                model(prompt, cache)
                cache.pos.fill_(pos)
                toks = torch.arange(T, device=dev)[None] + 7
                logits, cache = model(toks, cache)
                out.append((logits, cache))
            torch.cuda.synchronize()
            (lk, ck), (lp, cp) = out
            written = ck.k[..., :cfg.head_dim].abs().amax((0, 1, 2, 4)) > 0   # (S,)
            want = torch.zeros(S, dtype=torch.bool, device=dev)
            want[:P] = True
            want[S - T:] = True
            row = dict(cache="int8" if quant else "bf16", mode=mode, T=T, pos=pos,
                       finite=bool(torch.isfinite(lk).all()),
                       rows_written_as_clamped=bool(torch.equal(written, want)),
                       pos_after=int(ck.pos[0]), cache_equal_plain=cache_bytes_equal(ck, cp),
                       logits_nmse=nmse(lp.float().cpu().numpy(), lk.float().cpu().numpy()))
            rows.append(row)
            if not (row["finite"] and row["rows_written_as_clamped"] and row["cache_equal_plain"]
                    and row["pos_after"] == pos + T and row["logits_nmse"] <= PATH_NMSE):
                raise AssertionError(f"kv bounds: {row}")
    # one more kernel after the writes at the edge: the context is usable
    x = card.bf16(1, cfg.hidden_size)
    after, _ = check_k4(card, [("wqkv after", x, params["layers"][0]["wqkv"], {})])
    say("kv_bounds_check", rows=rows, kernel_after=after[0]["bitwise"])


def phi3_path(card):
    import numpy as np
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.generate import prefill
    from tmac_tpu_torch.runtime.sampling import sample
    from tmac_tpu_torch.utils import argmax_agreement, nmse, round_up
    t_path = time.perf_counter()
    cfg = dataclasses.replace(get_preset("phi-3-mini"), num_layers=PHI3_LAYERS)
    dev, L, H, I = card.dev, cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    max_len = PHI3_PROMPT + STEPS
    t0 = time.perf_counter()
    params = params_on_card(cfg, 0, dev)
    torch.cuda.synchronize()
    say("phi3_build", init_params_s=round(time.perf_counter() - t0, 3),
        layers=L, window=cfg.sliding_window, head_dim=cfg.head_dim,
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))

    S = round_up(max_len, 128)
    kv_rows, kv_err = check_kv_modes(card, S, cfg.sliding_window,
                                     (0, 1, 200, 2047, 2048, max_len, S))
    say("k6_k8_k9_check", at_s=round(time.perf_counter() - t_path, 3),
        checks=len(kv_rows), worst=kv_err, rows=kv_rows)
    l0, eps = params["layers"][0], cfg.rms_norm_eps
    k4_cases = []
    for N in DECODE_ROWS + K4L_ROWS:
        for shape, width, kw in (
                ("wqkv", H, dict(norm=(l0["attn_norm"], eps))),
                ("wo", cfg.q_dim, dict(residual=card.bf16(N, H))),
                ("gate_up", H, dict(norm=(l0["mlp_norm"], eps))),
                ("down", 2 * I, dict(glu=True, residual=card.bf16(N, H)))):
            x = card.bf16(N, width)
            k4_cases.append((shape, x, l0[shape], kw))
            k4_cases.append((shape, x[:, :l0[shape].kdim].contiguous(), l0[shape], {}))
    k4_checks, k4_err = check_k4(card, k4_cases)
    k1_rows, k1_err = check_k1(card, [("head", card.bf16(1, H), params["lm_head"], {})])
    say("k4_k1_check_phi3", at_s=round(time.perf_counter() - t_path, 3),
        k4=k4_checks, k1=k1_rows)
    del k4_cases

    # the main run: 2304-token prefill and 64 greedy steps through
    # decode_loop on an int8 cache, explicit KV writes (K6 reads the current
    # row back quantized); then the same on a bf16 cache (K6 with the window
    # only); each beside an eager loop of decode_step from the same cache
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PHI3_PROMPT))).to(dev)
    explicit = llama_in_mode(cfg, params, "explicit")
    chunks = -(-PHI3_PROMPT // 256)
    want_prefill = counts(K3=chunks, K4L=4 * L * chunks)
    runs = {}
    for name, quant in (("int8", True), ("bf16", False)):
        cache = KVCache.create(cfg, 1, max_len, device=dev, quant=quant)
        zero_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(explicit, tokens, cache)
        first = sample(logits)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = read_counts()
        snap = clone_cache(cache)
        out, _ = loop_decode(explicit, first, cache)
        total = read_counts()
        per_step, on_card = loop_counts(pre, total)
        gen = [int(first[0])] + out
        eager, step_ms = eager_decode(explicit, first.clone(), clone_cache(snap))
        ok = (bool(torch.isfinite(logits).all()) and len(gen) == STEPS + 1
              and all(0 <= t < cfg.vocab_size for t in gen)
              and int(cache.pos[0]) == max_len and pre == want_prefill
              and per_step == counts(K1=1.0, K4=4.0 * L, K6=float(L))
              and eager == out)
        runs[name] = dict(snap=snap, cache=cache, first=first, gen=gen,
                          step_ms=step_ms, prefill_s=prefill_s, launches=total,
                          on_card=on_card)
        say(f"phi3_{name}_main_path", model=cfg.name, prompt=PHI3_PROMPT,
            steps=STEPS, tokens=gen[:16], decode="decode_loop (CUDA graph)",
            launches_prefill=pre, launches_per_decode_step=per_step,
            launches_total=total, launched_on_card=on_card,
            eager_step_ms=step_ms, eager_tokens_equal=eager == out,
            prefill_host_s=prefill_s)
        if not ok:
            raise AssertionError(f"phi3 {name} cache: run failed its checks")

    # deferred (K8) and in-kernel (K9) steps from the int8 prefill's cache
    # through decode_loop, and an eager loop of the model keeping each
    # step's logits: the two modes compute one function and must agree bit
    # for bit
    for mode, label in (("deferred", "K8"), ("inkernel", "K9")):
        model = llama_in_mode(cfg, params, mode)
        cache = clone_cache(runs["int8"]["snap"])
        zero_counts()
        out, _ = loop_decode(model, runs["int8"]["first"].clone(), cache)
        total = read_counts()
        per_step, on_card = loop_counts(counts(), total)
        eager_cache, tok = clone_cache(runs["int8"]["snap"]), runs["int8"]["first"].clone()
        gen, lgs = [int(tok[0])], []
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.no_grad():
            start.record()
            for _ in range(STEPS):
                logits, eager_cache = model(tok[:, None], eager_cache)
                tok = sample(logits[:, -1])
                lgs.append(logits[0, -1])
                gen.append(tok)
            stop.record()
        torch.cuda.synchronize()
        gen = [gen[0]] + torch.stack(gen[1:]).reshape(-1).tolist()
        runs[mode] = dict(model=model, cache=eager_cache, gen=gen,
                          logits=torch.stack(lgs), launches=total, on_card=on_card,
                          step_ms=start.elapsed_time(stop) / STEPS)
        same = out == gen[1:] and cache_bytes_equal(cache, eager_cache)
        say(f"phi3_{mode}_path", tokens=gen[:16], decode="decode_loop (CUDA graph)",
            launches_per_decode_step=per_step, launches_total=total,
            launched_on_card=on_card, eager_step_ms=runs[mode]["step_ms"],
            decode_loop_equals_eager=same)
        if per_step != counts(K1=1.0, K4=4.0 * L, **{label: float(L)}) \
                or not bool(torch.isfinite(runs[mode]["logits"]).all()) or not same:
            raise AssertionError(f"phi3 {mode}: launches {per_step}, tokens and "
                                 f"cache equal to the eager loop's: {same}")
    d, k = runs["deferred"], runs["inkernel"]
    agree = dict(tokens=d["gen"] == k["gen"],
                 logits=bool(torch.equal(d["logits"], k["logits"])),
                 cache=cache_bytes_equal(d["cache"], k["cache"]))
    say("phi3_inkernel_vs_deferred", **agree,
        tokens_equal_explicit=d["gen"] == runs["int8"]["gen"])
    if not all(agree.values()):
        raise AssertionError(f"phi3: in-kernel differs from deferred: {agree}")

    # teacher-forced: the explicit and in-kernel steps against the plain
    # versions on the card, both from the int8 prefill's cache
    t0 = time.perf_counter()
    forced = runs["int8"]["gen"][:PHI3_FORCED]
    tf = {}
    for mode in ("explicit", "inkernel"):
        kernel = explicit if mode == "explicit" else k["model"]
        plain = llama_in_mode(cfg, params, mode, plain=True)
        ck, cp = clone_cache(runs["int8"]["snap"]), clone_cache(runs["int8"]["snap"])
        worst, agreement, bitwise = 0.0, [], True
        with torch.no_grad():
            for t in forced:
                step = torch.tensor([[t]], device=dev)
                lk, ck = kernel(step, ck)
                lp, cp = plain(step, cp)
                ref, got = lp[0].float().cpu().numpy(), lk[0].float().cpu().numpy()
                bitwise &= bool(torch.equal(lk, lp))
                worst = max(worst, nmse(ref, got))
                agreement.append(argmax_agreement(ref, got, TIE_MARGIN))
        tf[mode] = dict(max_nmse=worst, argmax_agreement=min(agreement),
                        bitwise=bitwise, cache_equal=cache_bytes_equal(ck, cp))
        del plain, ck, cp
    say("phi3_teacher_forced", steps=len(forced), seconds=round(time.perf_counter() - t0, 3),
        **tf)
    if not all(r["max_nmse"] <= PATH_NMSE and r["argmax_agreement"] == 1.0
               and r["cache_equal"] for r in tf.values()):
        raise AssertionError(f"phi3: teacher-forced: {tf}")

    # each mode's step captured in a CUDA graph from the prefill's cache
    # (graph_decode): it must replay the eager tokens; then decode_loop
    # timed three times in each mode
    graphs = {}
    for mode, model, src in (("int8", explicit, "int8"), ("bf16", explicit, "bf16"),
                             ("deferred", d["model"], "int8"),
                             ("inkernel", k["model"], "int8")):
        cache = clone_cache(runs[src]["snap"])
        ms, replayed = graph_decode(model, cache, runs[src]["first"].clone())
        graphs[mode] = dict(step_ms=ms, tokens_per_s=1e3 / ms,
                            eager_step_ms=runs[mode]["step_ms"],
                            tokens_equal_eager=replayed == runs[mode]["gen"][1:])
        loop_ms, spread = loop_rates(card, f"phi3_{mode}", model, runs[src]["snap"],
                                     runs[src]["first"], runs[mode]["gen"][1:],
                                     runs[mode]["step_ms"])
        STEP_MS[f"phi3 {mode}"] = dict(
            eager=runs[mode]["step_ms"], graph=ms, loop=loop_ms,
            loop_min_median_max=[spread[0], spread[len(spread) // 2], spread[-1]],
            prefill_s=runs[src].get("prefill_s"), launched_on_card=runs[mode]["on_card"])
    say("phi3_decode_graph", card=card.name, nvidia_smi=card.smi, **graphs)
    if not all(g["tokens_equal_eager"] for g in graphs.values()):
        raise AssertionError("phi3: a graph-replayed decode gave other tokens")
    for mode, model, src in (("int8", explicit, "int8"), ("bf16", explicit, "bf16"),
                             ("inkernel", k["model"], "int8")):
        device_time(f"phi3_{mode}", model, clone_cache(runs[src]["snap"]),
                    runs[src]["first"], runs[mode]["step_ms"], graphs[mode]["step_ms"])

    # per-call times: K6, K8, K9 at 2048 cached rows; K4 and the head at N=1
    times = time_kv_modes(card, cfg, dict(int8=runs["int8"]["cache"],
                                          bf16=runs["bf16"]["cache"],
                                          scratch=k["cache"]),
                          n=min(2048, PHI3_PROMPT))
    say("k6_k8_k9_times", at_s=round(time.perf_counter() - t_path, 3),
        per_step=L, card=card.name, nvidia_smi=card.smi, **times)
    layers = params["layers"]
    k4_tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    k4_rows = []
    for shape, width in (("wqkv", H), ("wo", cfg.q_dim), ("gate_up", H),
                         ("down", 2 * I)):
        calls = []
        for i in range(L):
            kw = {"wqkv": lambda: dict(norm=(layers[i]["attn_norm"], eps)),
                  "gate_up": lambda: dict(norm=(layers[i]["mlp_norm"], eps)),
                  "wo": lambda: dict(residual=card.bf16(1, H)),
                  "down": lambda: dict(glu=True, residual=card.bf16(1, H))}[shape]()
            calls.append((card.bf16(1, width), layers[i][shape], kw))
        k4_rows.append(dict(shape=shape, **time_k4(card, calls)))
        for key in k4_tot:
            k4_tot[key] += L * k4_rows[-1][key]
    h_ms, h_plain, h_bound, h_lib = time_head(card, params["lm_head"])
    say("k4_k1_times_phi3", at_s=round(time.perf_counter() - t_path, 3),
        k4=k4_rows, k4_per_step=dict(k4_tot, calls=4 * L), head_ms=h_ms,
        head_plain_ms=h_plain, head_bound_ms=h_bound, head_library_ms=h_lib)
    # K4L per call at the prefill's 256 rows (over 4 layers' weights), and
    # per 2304-token prefill: 4 linears a layer a chunk
    k4l_tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    k4l_rows = []
    for shape, width in (("wqkv", H), ("wo", cfg.q_dim), ("gate_up", H),
                         ("down", 2 * I)):
        calls = []
        for i in range(min(4, L)):
            kw = {"wqkv": lambda: dict(norm=(layers[i]["attn_norm"], eps)),
                  "gate_up": lambda: dict(norm=(layers[i]["mlp_norm"], eps)),
                  "wo": lambda: dict(residual=card.bf16(256, H)),
                  "down": lambda: dict(glu=True, residual=card.bf16(256, H))}[shape]()
            calls.append((card.bf16(256, width), layers[i][shape], kw))
        k4l_rows.append(dict(shape=shape, per_prefill=L * chunks,
                             **time_k4(card, calls, reps=5)))
        for key in k4l_tot:
            k4l_tot[key] += L * chunks * k4l_rows[-1][key]
    prefill_ms = runs["int8"]["prefill_s"] * 1e3
    say("k4l_times_phi3", at_s=round(time.perf_counter() - t_path, 3), rows=k4l_rows,
        per_prefill=dict(k4l_tot, calls=4 * L * chunks), prefill_ms=prefill_ms,
        k4l_share_of_prefill=k4l_tot["ms"] / prefill_ms, card=card.name,
        nvidia_smi=card.smi)
    # where the prefill's device time goes, by kernel (a second int8 run)
    cache = KVCache.create(cfg, 1, max_len, device=dev, quant=True)
    by_kernel = profiled_ms(lambda: prefill(explicit, tokens, cache))
    busy = sum(by_kernel.values())
    say("phi3_prefill_device_time", ms=by_kernel, busy_ms=busy, host_ms=prefill_ms,
        k4l_share_of_busy=(by_kernel.get("K4/K4L prologue", 0.0)
                           + by_kernel.get("K4L matmul", 0.0)) / busy)
    del cache
    check_kv_bounds(card, cfg, params, tokens[:, :8])
    bound = k4_tot["bound_ms"] + h_bound
    say("phi3_step", card=card.name, nvidia_smi=card.smi,
        kernel_bound_ms={m: bound + L * times[t]["bound_ms"] for m, t in (
            ("int8", "K6 int8"), ("bf16", "K6 bf16"), ("deferred", "K8 int8"),
            ("inkernel", "K9 int8"))},
        graph_ms={m: g["step_ms"] for m, g in graphs.items()},
        path_s=round(time.perf_counter() - t_path, 3))

    def row(name, label, replaces, t, launches, err):
        return dict(name=name, path="phi-3-mini", route="cuda",
                    source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=t["ms"] * L, plain_ms=t["plain_ms"] * L,
                    bound_ms=t["bound_ms"] * L, bound_by=t["bound_by"],
                    library_ms=t["library_ms"] * L)
    site = "tmac_tpu/ops/pallas/attention_kernel.py:"
    return [
        row("flash_decode_split (K6)", "K6", site + "367", times["K6 int8"],
            runs["int8"]["launches"]["K6"], kv_err["K6"]),
        row("flash_decode_append (K8)", "K8", site + "450", times["K8 int8"],
            runs["deferred"]["launches"]["K8"], kv_err["K8"]),
        row("flash_decode_append_write (K9)", "K9", site + "552",
            times["K9 int8"], runs["inkernel"]["launches"]["K9"], kv_err["K9"]),
        dict(name="qgemm_grouped (K4)", path="phi-3-mini", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=runs["int8"]["launches"]["K4"], max_abs_err=k4_err,
             ms=k4_tot["ms"], plain_ms=k4_tot["plain_ms"],
             bound_ms=k4_tot["bound_ms"], bound_by="bytes",
             library_ms=k4_tot["library_ms"]),
        dict(name="qgemm_grouped_large (K4L)", path="phi-3-mini", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped_large.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:428",
             launches=runs["int8"]["launches"]["K4L"],
             max_abs_err=max(r["max_abs_err"] for r in k4_checks if r["kernel"] == "K4L"),
             ms=k4l_tot["ms"], plain_ms=k4l_tot["plain_ms"],
             bound_ms=k4l_tot["bound_ms"], bound_by=dominant_bound(k4l_rows),
             library_ms=k4l_tot["library_ms"]),
        dict(name="qgemm_fused (K1)", path="phi-3-mini", route="cuda",
             source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
             replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
             launches=runs["int8"]["launches"]["K1"], max_abs_err=k1_err,
             ms=h_ms, plain_ms=h_plain, bound_ms=h_bound, bound_by="bytes",
             library_ms=h_lib),
    ]


# ---------------------------------------------------------------------------
# paths 5 and 6: Llama-3.1-8B W3A16 g128 (llama3 rope scaling) and
# Qwen2-7B W4A16 g128 (attention bias, GQA rep 7)
# ---------------------------------------------------------------------------

# Llama-3.1-8B's 768-token prompt in chunks of 512 (K5 at bits 3) and 256
# (K4L at bits 3); Qwen2-7B's 256 tokens in one chunk (K4L at bits 4); the
# decode steps teacher-forced against the plain versions
W3_PROMPT, W3_CHUNK, QWEN_PROMPT, NEW_FORCED = 768, 512, 256, 2


def check_k2_heads(card, KV, rep, Dl, S=2048):
    """K2 against its plain version at one head shape (KV heads of rep
    query heads, head_dim Dl) on an S-row bf16 cache: lengths 1, 17, 1056
    and S - 1, at split_plan's cluster size and at 1 and 8, bit for bit.
    -> (rows, worst abs error)"""
    import numpy as np
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as k2
    dev, rng = card.dev, card.rng
    kc = torch.zeros((2, 1, KV, S, 128), device=dev)
    vc = torch.zeros_like(kc)
    for c in (kc, vc):
        c[..., :Dl] = torch.from_numpy(rng.standard_normal((2, 1, KV, S, Dl))
                                       .astype(np.float32)).to(dev)
    kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    q = card.bf16(1, KV, rep, Dl)
    li = torch.tensor([1], dtype=torch.int32, device=dev)
    rows, worst = [], 0.0
    for n in (1, 17, 1056, S - 1):
        kl = torch.tensor([n], dtype=torch.int32, device=dev)
        for nsplit in (None, 1, 8):
            got = k2.flash_decode(q, kc, vc, kl, li, nsplit=nsplit)
            want = k2.flash_decode_plain(q, kc, vc, kl, li, nsplit=nsplit)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            rows.append(dict(KV=KV, rep=rep, len=n, nsplit=nsplit, max_abs_err=err,
                             bitwise=bool(torch.equal(got, want))))
            if not rows[-1]["bitwise"]:
                raise AssertionError(f"K2 check failed: {rows[-1]}")
    return rows, worst


LINEARS = ("wqkv", "wo", "gate_up", "down")


def linear_call(card, cfg, shape, N, layer, folds=True, with_ags=True):
    """(x, weight, folds) of a layer's linear at N rows, with its model's
    folds (the norm into wqkv and gate_up, the residual into wo and down,
    SwiGLU into an unpadded down) unless folds is off, and with act_gs
    (K4's function in the ags form) unless with_ags is off (K5, ags 0)."""
    qt, ags = layer[shape], cfg.quant.act_group_size
    if shape in ("wqkv", "gate_up"):
        kw = dict(norm=(layer["attn_norm" if shape == "wqkv" else "mlp_norm"],
                        cfg.rms_norm_eps))
        width = cfg.hidden_size
    else:
        kw, width = dict(residual=card.bf16(N, qt.mdim)), qt.kdim
        if shape == "down" and qt.kdim_padded == qt.kdim:
            kw["glu"], width = True, 2 * qt.kdim
    kw = kw if folds else {}
    if ags and with_ags:
        kw["act_gs"] = ags
    return card.bf16(N, width if folds else qt.kdim), qt, kw


def per_linear_times(card, cfg, layers, N, timer, count, with_ags=True):
    """Each linear's time per call at N rows (over the layers' weights; 4
    layers' from 64 rows) by `timer`, summed over `count` calls of each:
    (rows, totals of ms, plain_ms, bound_ms and library_ms)."""
    rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for sh in LINEARS:
        calls = [linear_call(card, cfg, sh, N, layers[i], with_ags=with_ags)
                 for i in range(len(layers) if N == 1 else min(4, len(layers)))]
        rows.append(dict(shape=sh, per=count, **timer(card, calls)))
        for key in tot:
            tot[key] += count * rows[-1][key]
    return rows, tot


def grouped_path(card, tag, cfg, prompt_len, chunk, serve=None, params=None,
                 k4_rows=(1, 4, 16, 64, 256), k5_rows=(384, 512), forced=NEW_FORCED):
    """A grouped-scale model at full width and depth, weights drawn on the
    card (params_on_card): K4 (N = 1, 4, 16, at every cluster size of the
    checks), K4L (N = 64, 256) and, where a chunk takes it, K5 (N = 384,
    512 and each chunk's rows that take K5) on layer 0's four linears with
    their folds and without, K1 and K3 on the head and K2 at the model's
    head shape, each against its plain version; then run_path's main run
    (prefill in chunks, decode_loop, the teacher-forced check: on the
    prompt's last position when a chunk takes K5, else on every position)
    and the kernels' device times per step and per prefill (K5 and K4L
    timed at the rows of each chunk the route sends them).  With the
    config's act_group_size the K4 and K4L checks, timings and records are
    the ags form's, K4 also timed at ags 0 on the same weights, and the ags
    and ags 0 logits at the prompt's last position are held against a bf16
    dequant forward (ags_accuracy, printed).  serve(card, cfg, params,
    model), when given, runs last on the path's weights and model
    (engine_serve) and adds its records.  params: the model's weights on
    the card (gguf_path's, read from a gguf file), else drawn here;
    k4_rows, k5_rows: the rows of the K4 and K4L, and K5 checks; forced:
    the decode steps teacher-forced.  -> the kernels' records"""
    import torch
    from tmac_tpu_torch.ops.qgemm import route
    t_path = time.perf_counter()
    if params is None:
        params = params_on_card(cfg, 0, card.dev)
    torch.cuda.synchronize()
    say(f"{tag}_build", model=cfg.name, bits=cfg.quant.bits, layers=cfg.num_layers,
        act_group_size=cfg.quant.act_group_size,
        init_params_s=round(time.perf_counter() - t_path, 3))
    layers, L = params["layers"], cfg.num_layers
    H, rep = cfg.hidden_size, cfg.num_heads // cfg.num_kv_heads
    ags = cfg.quant.act_group_size

    def args(shape, N, layer, folds=True, with_ags=True):
        return linear_call(card, cfg, shape, N, layer, folds, with_ags)

    shapes = LINEARS
    l0 = layers[0]
    cases = [(sh, *args(sh, N, l0)) for sh in shapes for N in k4_rows]
    cases += [(sh, *args(sh, N, l0, False)) for sh in shapes for N in (1, 64)]
    k4_rows, _ = check_k4(card, cases)
    k4_err = max(r.get("max_abs_err", 0.0) for r in k4_rows if r["kernel"] == "K4")
    k4l_err = max(r.get("max_abs_err", 0.0) for r in k4_rows if r["kernel"] == "K4L")
    # the prompt's chunks by kernel: {rows: chunks of those rows}
    pieces = [min(chunk, prompt_len - o) for o in range(0, prompt_len, chunk)]
    by_kernel = {k: collections.Counter(n for n in pieces if route(l0["wqkv"], n) == k)
                 for k in ("K5", "K4L")}
    k5_chunks, k4l_chunks = (sum(by_kernel[k].values()) for k in ("K5", "K4L"))
    k5_rows, k5_err = check_k5(card, [(sh, *args(sh, N, l0, with_ags=False))
                                      for N in sorted(set(k5_rows) | set(by_kernel["K5"]))
                                      for sh in shapes]
                               ) if k5_chunks else ([], 0.0)
    head = params["lm_head"]
    k1_rows, k1_err = check_k1(card, [("head", card.bf16(1, H), head, {})])
    k3_rows, k3_err = check_k3(card, [("head", card.bf16(chunk, H), head, {})])
    k2_rows, k2_err = check_k2_heads(card, cfg.num_kv_heads, rep, cfg.head_dim)
    say(f"{tag}_checks", at_s=round(time.perf_counter() - t_path, 3), k4=k4_rows,
        k5=k5_rows, k1=k1_rows, k3=k3_rows, k2=k2_rows)

    # the prefill: K5 or K4L on 4 linears a layer a chunk, K3 on the head a
    # chunk; a decode step: K4 on 4 linears a layer, K1 on the head, K2 a layer
    main = run_path(card, tag, cfg, params, prompt_len,
                    counts(K3=len(pieces), K5=4 * L * k5_chunks, K4L=4 * L * k4l_chunks),
                    counts(K1=1.0, K4=4.0 * L, K2=float(L)), forced=forced, chunk=chunk,
                    tf_gate=LLAMA_TF_NMSE if k5_chunks else None,
                    tf_last_only=bool(k5_chunks))
    launches = main["launches"]
    if ags:
        say(f"{tag}_ags_accuracy", **ags_accuracy(card, cfg, params, main["prompt"], chunk))

    def per(N, timer, count, with_ags=True):
        return per_linear_times(card, cfg, layers, N, timer, count, with_ags)

    def per_chunks(kernel, timer, with_ags=True):
        """`kernel`'s rows and totals over the prompt's chunks it takes,
        each chunk's linears timed at that chunk's rows."""
        rows, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        for n, c in sorted(by_kernel[kernel].items()):
            r, t = per(n, timer, L * c, with_ags)
            rows += r
            for key in tot:
                tot[key] += t[key]
        return rows, tot

    k4_times, k4_tot = per(1, time_k4, L)
    # the ags form beside K4 at ags 0 on the same weights
    ags0 = dict(ags0_per_step=per(1, time_k4, L, with_ags=False)[1]) if ags else {}
    say(f"{tag}_k4_times", rows=k4_times, per_step=dict(k4_tot, calls=4 * L),
        act_group_size=ags, **ags0)
    k4l_times, k4l_tot = per_chunks("K4L", lambda c, calls: time_k4(c, calls, reps=5))
    say(f"{tag}_k4l_times", rows=k4l_times, per_prefill=dict(k4l_tot, calls=4 * L * k4l_chunks),
        act_group_size=ags)
    k5_times, k5_tot = per_chunks("K5", time_k5, with_ags=False)
    if k5_chunks:
        say(f"{tag}_k5_times", rows=k5_times, per_prefill=dict(k5_tot, calls=4 * L * k5_chunks))
    h_ms, h_plain, h_bound, h_lib = time_head(card, head)
    kv_len = prompt_len + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, main["cache"], kv_len)
    say(f"{tag}_step", eager_ms=main["step_ms"], graph_ms=main["graph_step_ms"],
        decode_loop_ms=main["loop_ms"],
        kernel_bound_ms=k4_tot["bound_ms"] + h_bound + k2_bound * L,
        head_ms=h_ms, head_bound_ms=h_bound, head_plain_ms=h_plain, head_library_ms=h_lib,
        kv_len=kv_len, k2_ms=k2_ms,
        k2_bound_ms=k2_bound, k2_library_ms=k2_lib, card=card.name, nvidia_smi=card.smi,
        path_s=round(time.perf_counter() - t_path, 3))
    bits, src = l0["wqkv"].bits, "tmac_tpu_torch/ops/cuda/csrc/"
    sform = " f32 scales" if l0["wqkv"].scales.dtype == torch.float32 else ""
    sform += " gs 16" if l0["wqkv"].group_size == 16 else ""
    form = (f" ags {ags}" if ags else "") + sform

    def rec(name, source, replaces, label, err, t, by):
        return dict(name=name, path=cfg.name + (f"-ags{ags}" if ags else ""),
                    route="cuda", source=src + source,
                    replaces="tmac_tpu/ops/pallas/" + replaces, launches=launches[label],
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=by, library_ms=t["library_ms"])
    records = [
        rec(f"qgemm_grouped (K4) bits {bits}{form}", "qgemm_grouped.cu",
            "qgemm_kernel.py:567", "K4", k4_err, k4_tot, "bytes"),
        rec(f"flash_decode (K2) rep {rep}", "flash_decode.cu", "attention_kernel.py:367",
            "K2", k2_err, dict(ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
                               library_ms=k2_lib * L), "bytes"),
    ]
    if k4l_chunks:   # (gs 16: every chunk of 64 rows or more takes K5)
        records.insert(1, rec(f"qgemm_grouped_large (K4L) bits {bits}{form}",
                              "qgemm_grouped_large.cu", "qgemm_kernel.py:428", "K4L",
                              k4l_err, k4l_tot, dominant_bound(k4l_times)))
    if k5_chunks:
        records.append(rec(f"qgemm_dequant (K5) bits {bits}{sform}", "qgemm_large.cu",
                           "qgemm_kernel.py:319", "K5", k5_err, k5_tot,
                           dominant_bound(k5_times)))
    if serve is not None:
        records += serve(card, cfg, params, main["model"])
    del params, main
    return records


# ---------------------------------------------------------------------------
# engine_serve: the continuous-batching engine, its HTTP server and the
# serving bench on Qwen2-7B W4A16 g128
# ---------------------------------------------------------------------------

SERVE_ENGINE = dict(max_batch=8, max_len=2048, prefill_chunk=512, decode_chunk=16,
                    max_decode_chunk=64, prefix_cache_size=4)
# the bench: SERVE_REQUESTS prompts of 16-700 tokens at seed 0, the last
# SERVE_SHARED of them a shared SERVE_PREFIX-token prefix and 16-400 tokens
# more, budgets of 32-96 tokens, Poisson arrivals at SERVE_RATE a second
# (all within ~0.2 s: the 8 slots stay full while 8 requests wait)
SERVE_REQUESTS, SERVE_SHARED, SERVE_PREFIX, SERVE_RATE = 16, 4, 300, 80.0
# the int8-cache run: SERVE_INT8 prompts of 16-300 tokens, budgets 16-48
SERVE_INT8 = 8
# the mixed batch's sampler; logprob records against a teacher-forced
# log-softmax
SERVE_SAMPLED, LOGPROB_TOL = dict(temperature=0.8, top_p=0.95), 1e-4


def serve_traffic(V, n, hi, new_lo, new_hi, shared=0, seed=0):
    """n prompts of 16-hi random tokens, the last `shared` of them
    SERVE_PREFIX shared tokens and 16 to hi - SERVE_PREFIX more, and their
    budgets of new_lo-new_hi tokens, from `seed`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, V, SERVE_PREFIX).tolist()
    prompts, budgets = [], []
    for i in range(n):
        if i >= n - shared:
            tail = int(rng.integers(16, hi - SERVE_PREFIX + 1))
            prompts.append(prefix + rng.integers(0, V, tail).tolist())
        else:
            prompts.append(rng.integers(0, V, int(rng.integers(16, hi + 1))).tolist())
        budgets.append(int(rng.integers(new_lo, new_hi + 1)))
    return prompts, budgets


def engine_counters(eng):
    """The engine's counters that account for launches (a copy)."""
    st = eng.stats
    return dict(prefill_chunks=dict(st["prefill_chunks"]), eager_steps=st["eager_steps"],
                graph_captures=st["graph_captures"], graph_replays=st["graph_replays"],
                replay_ms=st["replay_ms"], decode_s=st["decode_s"], chunks=st["chunks"])


def engine_run_launches(cfg, params, before, after, quant, warm_buckets=()):
    """An engine run's launches from its counters (before and after it;
    warm_buckets: the buckets of a warm-up inside the run, a chunk each,
    which the prefill counters do not count): per prefill chunk of bucket
    b, 4 L calls of route(wqkv, b) and one of route(head, b); per decode
    step, 4 L K4, 1 K1 and L K2 (K6 on an int8 cache).  The wrappers count
    a decode step where the host runs it: an eager step (a capture's
    warm-up among them), or a capture's recording (whose replays run
    without the host).  -> (wrapper calls, launched on the card, a step's
    launches)"""
    from tmac_tpu_torch.ops.qgemm import route
    L = cfg.num_layers
    wqkv, head = params["layers"][0]["wqkv"], params["lm_head"]
    calls, step = counts(), counts(K4=4 * L, K1=1, **{"K6" if quant else "K2": L})
    chunks = {b: n - before["prefill_chunks"].get(b, 0)
              for b, n in after["prefill_chunks"].items()}
    for b in warm_buckets:
        chunks[b] = chunks.get(b, 0) + 1
    for b, n in chunks.items():
        calls[route(wqkv, b)] += 4 * L * n
        calls[route(head, b)] += n
    d = {k: after[k] - before[k] for k in ("eager_steps", "graph_captures", "graph_replays")}
    on_card = dict(calls)
    for k in COUNTERS:
        calls[k] += step[k] * (d["eager_steps"] + d["graph_captures"])
        on_card[k] += step[k] * (d["eager_steps"] + d["graph_replays"])
    return calls, on_card, step


# the single-stream comparison: prompts whose lengths are prefill buckets
# no longer than generate's prefill chunk (256), so that the engine's
# bucket and generate's chunk run the same kernels on the same rows;
# budgets of 24-48 tokens from seed 2, WITNESS_LOGPROBS alternatives
# recorded
WITNESS_LENS, WITNESS_LOGPROBS = (256, 16, 64, 256, 16, 64, 256, 64), 4


@contextlib.contextmanager
def one_row_forms():
    """Every form of the decode step that depends on the batch's row count
    set to its one-row form while the context is open: K1's and K4's plan
    (decode_plan: the cluster size along K and the token rows a block),
    K2/K6's blocks a head (split_plan) and the final rms_norm, run a row
    at a time (torch sizes a reduction's blocks by its row count, so a
    row's f32 sum of squares can differ between 1 and 8 rows).  Each row
    of a batch then takes a batch of one's arithmetic; K7's plan (experts)
    is left as it is."""
    import torch
    from tmac_tpu_torch.models import llama
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    saved = k1.decode_plan, k4.decode_plan, ak.split_plan, llama.rms_norm

    def one_row(plan):
        return lambda N, *a, **k: plan(N if k.get("experts") else 1, *a, **k)

    def norm(x, w, eps):
        return torch.cat([saved[3](x[i:i + 1], w, eps) for i in range(x.shape[0])])
    k1.decode_plan, k4.decode_plan = one_row(saved[0]), one_row(saved[1])
    ak.split_plan = lambda B, *a, **k: saved[2](1, *a, **k)
    llama.rms_norm = norm
    try:
        yield
    finally:
        k1.decode_plan, k4.decode_plan, ak.split_plan, llama.rms_norm = saved


class SingleStream:
    """The single-stream path teacher-forced: a prompt through generate's
    prefill (chunks of 256) on a one-row cache of SERVE_ENGINE's length,
    then one captured decode step (B = 1) replayed over given tokens, which
    it reads on the card, each step's logits into a row of `rows` (row 0:
    the prompt's last position's).  The cache keeps the stream's rows."""

    def __init__(self, model, width, quant=False):
        import torch
        from tmac_tpu_torch.models.llama import KVCache
        dev = model.device
        self.model = model
        self.cache = KVCache.create(model.cfg, 1, SERVE_ENGINE["max_len"], device=dev,
                                    quant=quant)
        self.seq = torch.zeros((width,), dtype=torch.long, device=dev)
        self.col = torch.zeros((1,), dtype=torch.long, device=dev)
        self.rows = torch.zeros((width + 1, model.cfg.vocab_size), device=dev)
        self.graph = None

    def _step(self):
        lg, _ = self.model(self.seq.index_select(0, self.col)[:, None], self.cache)
        self.rows.index_copy_(0, self.col + 1, lg[:, -1])
        self.col.add_(1)

    def run(self, prompt, toks):
        """-> rows (len(toks), V): the logits each of toks was drawn from."""
        import torch
        from tmac_tpu_torch.runtime.generate import prefill
        self.cache.pos.zero_()
        last, _ = prefill(self.model, torch.tensor([prompt], device=self.seq.device),
                          self.cache)
        self.rows[0].copy_(last[0])
        n = len(toks) - 1
        if n > 0:
            self.seq[:n].copy_(torch.tensor(toks[:-1]))
            self.col.zero_()
            done = 0
            if self.graph is None:
                self.graph = capture(self._step)  # its warm-up is step 0
                done = 1
            for _ in range(n - done):
                self.graph.replay()
        return self.rows[:len(toks)]


def kv_rows_equal(cache, slot, one, n):
    """Whether the first n rows of `slot` in every layer of cache (and of
    an int8 cache's scales) equal the one-row cache one's, bit for bit."""
    import torch
    return all(torch.equal(a[:, slot, :, :n], b[:, 0, :, :n])
               for a, b in ((cache.k, one.k), (cache.v, one.v),
                            (cache.k_scale, one.k_scale), (cache.v_scale, one.v_scale))
               if a is not None)


def prefill_slot_check(model, prompt, slot, quant):
    """prefill_slot of a bucket-length prompt (no padding) into `slot` of
    an empty 8-slot cache of SERVE_ENGINE's rows against generate's prefill
    of it on a one-row cache: the last logits and every layer's KV rows
    (and scales) bit for bit, the slot's pos the prompt's length and the
    other slots untouched.  -> the record."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.engine import prefill_slot
    from tmac_tpu_torch.runtime.generate import prefill
    dev, n = model.device, len(prompt)
    big, one = (KVCache.create(model.cfg, b, SERVE_ENGINE["max_len"], device=dev, quant=quant)
                for b in (8, 1))
    x = torch.tensor([prompt], device=dev)
    got, _ = prefill_slot(model, x, n, big, slot, 0)
    want, _ = prefill(model, x, one)
    others = [i for i in range(8) if i != slot]
    bufs = [t for t in (big.k, big.v, big.k_scale, big.v_scale) if t is not None]
    rec = dict(prompt_len=n, slot=slot, int8_cache=quant,
               logits_equal=torch.equal(got, want[0]),
               kv_rows_equal=kv_rows_equal(big, slot, one, n),
               pos=big.pos.tolist(),
               others_untouched=not any(bool(t[:, others].any()) for t in bufs))
    rec["ok"] = (rec["logits_equal"] and rec["kv_rows_equal"] and rec["others_untouched"]
                 and rec["pos"] == [n if i == slot else 0 for i in range(8)])
    return rec


def engine_streams(model, prompts, budgets, quant):
    """The prompts submitted together to a cold engine of SERVE_ENGINE (no
    prefix cache; an int8 cache with quant), greedy, WITNESS_LOGPROBS
    alternatives recorded; request i takes slot i (all are admitted in
    the first tick).  -> (the engine, the finished requests in order)."""
    from tmac_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine(model, **dict(SERVE_ENGINE, prefix_cache_size=0, kv_quant=quant))
    uids = [eng.submit(p, max_new_tokens=b, logprobs=WITNESS_LOGPROBS)
            for p, b in zip(prompts, budgets)]
    eng.step()
    if [None if r is None else r.uid for r in eng.slots] != uids:
        raise AssertionError(f"engine_serve: slots {eng.slots} after the first tick")
    eng.run()
    return eng, [eng.finished[u] for u in uids]


def single_stream_check(model, quant):
    """The engine against the single-stream path (B = 1): the witness
    prompts (WITNESS_LENS, seed 2) submitted together to a cold engine
    twice, on its own 8-row plans and under one_row_forms, each greedy
    stream against generate()'s tokens for its prompt (one row of
    SERVE_ENGINE's length, under one_row_forms: its 16-row prefills take
    the one-row plan, as the engine's do there) and teacher-forced
    (SingleStream): the slot's KV rows of every layer, each token the
    argmax of its row, the tie-aware agreement and the logprob records
    against the rows' log-softmax.  -> {"own_plans": ..., "one_row": ...}
    (under one_row_forms every stream must equal, the caller checks)."""
    import numpy as np
    import torch
    from tmac_tpu_torch.runtime.generate import generate
    rng = np.random.default_rng(2)
    V = model.cfg.vocab_size
    prompts = [rng.integers(0, V, n).tolist() for n in WITNESS_LENS]
    budgets = [int(rng.integers(24, 49)) for _ in WITNESS_LENS]
    runs = {"own_plans": engine_streams(model, prompts, budgets, quant)}
    out = {}
    with one_row_forms():
        runs["one_row"] = engine_streams(model, prompts, budgets, quant)
        ref = [generate(model, [p], b, max_len=SERVE_ENGINE["max_len"],
                        kv_quant=quant)[0].tolist() for p, b in zip(prompts, budgets)]
        ss = SingleStream(model, max(budgets), quant)
        for name, (eng, reqs) in runs.items():
            rec = dict(streams=len(reqs), tokens_equal_generate=0, kv_rows_equal=0,
                       argmax_every_token=0, min_tie_aware_agreement=1.0,
                       logprob_max_abs_err=0.0)
            for slot, (p, r, want) in enumerate(zip(prompts, reqs, ref)):
                rows = ss.run(p, r.output)
                a, same = tf_agreement(rows, r.output)
                rec["tokens_equal_generate"] += r.output == want
                rec["kv_rows_equal"] += kv_rows_equal(eng.cache, slot, ss.cache,
                                                      len(p) + len(r.output) - 1)
                rec["argmax_every_token"] += same
                rec["min_tie_aware_agreement"] = min(rec["min_tie_aware_agreement"], a)
                rec["logprob_max_abs_err"] = max(rec["logprob_max_abs_err"],
                                                 lp_error(r.logprobs_out, r.output, rows))
            out[name] = rec
        del ss
    del runs
    torch.cuda.empty_cache()
    return dict(prompt_lens=list(WITNESS_LENS), budgets=budgets, int8_cache=quant, **out)


def norm_rows_differing(model, trials=200):
    """The final rms_norm (the model's weight and eps) of random bf16 rows
    of the model's width, 8 at once against each row alone: -> (rows whose
    output differs in any bit, rows)."""
    import torch
    from tmac_tpu_torch.models.llama import rms_norm
    cfg, dev = model.cfg, model.device
    g = torch.Generator(device=dev).manual_seed(0)
    differ = 0
    for _ in range(trials):
        x = torch.randn((8, 1, cfg.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        both = rms_norm(x, model.final_norm, cfg.rms_norm_eps)
        differ += sum(not torch.equal(both[i:i + 1],
                                      rms_norm(x[i:i + 1], model.final_norm, cfg.rms_norm_eps))
                      for i in range(8))
    return differ, 8 * trials


def tf_agreement(rows, toks):
    """(argmax_agreement's tie-aware share at TIE_MARGIN of toks against
    rows (n, V) on the card, whether every token is rows' argmax)."""
    import torch
    t = torch.tensor(toks, device=rows.device)
    top2 = torch.topk(rows, 2, dim=-1).values
    chosen = rows.gather(1, t[:, None])[:, 0]
    argmax = rows.argmax(-1) == t
    ok = argmax | (top2[:, 0] - chosen < TIE_MARGIN) | (top2[:, 0] - top2[:, 1] < TIE_MARGIN)
    return float(ok.float().mean()), bool(argmax.all())


def lp_error(recs, toks, rows):
    """The largest difference of logprob records (the chosen token's and
    the top alternatives') from the log-softmax of teacher-forced rows."""
    import torch
    logp = torch.log_softmax(rows[:len(toks)], dim=-1)
    top = torch.topk(logp, len(recs[0]["top"]), dim=-1).values.tolist()
    return max(max(abs(r["logprob"] - float(logp[i, t])),
                   *(abs(v - w) for (_, v), w in zip(r["top"], top[i])))
               for i, (r, t) in enumerate(zip(recs, toks)))


def plain_batch_step(model, plain, eng):
    """One decode step of an engine's 8 live slots (its cache copied, its
    last tokens) by the kernel path and by the plain versions, B = 8: ->
    (worst logits NMSE of a row, least tie-aware argmax agreement)."""
    import torch
    from tmac_tpu_torch.utils import argmax_agreement, nmse
    tok = torch.from_numpy(eng.last_tokens.copy()).to(model.device)[:, None]
    lk, _ = model(tok, clone_cache(eng.cache))
    lp, _ = plain(tok, clone_cache(eng.cache))
    ref, got = lp[:, -1].float().cpu().numpy(), lk[:, -1].float().cpu().numpy()
    return (max(nmse(r, g) for r, g in zip(ref, got)),
            min(argmax_agreement(r, g, TIE_MARGIN) for r, g in zip(ref, got)))


def time_k2_batch(card, cfg, cache, lens):
    """K2 (K6 on an int8 cache) per call over an engine's cache of B slots
    at per-slot lengths lens: (ms, plain ms, bound ms, SDPA ms with a
    length mask over the rows, dequantized to bf16 beforehand on an int8
    cache)."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    dev, L, Dl = card.dev, cfg.num_layers, cfg.head_dim
    KVh, rep, B = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, len(lens)
    kw = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    q = card.bf16(B, KVh, rep, Dl)
    kl = torch.tensor(lens, dtype=torch.int32, device=dev)
    lis = [torch.tensor([i], dtype=torch.int32, device=dev) for i in range(L)]
    ms = graph_ms(lambda: [ak.flash_decode(q, cache.k, cache.v, kl, i, **kw)
                           for i in lis]) / L
    plain = cuda_ms(lambda: ak.flash_decode_plain(q, cache.k, cache.v, kl, lis[1], **kw), 3)
    S = max(lens)

    def rows(buf, sbuf, i):
        x = buf[i, :, :, :S, :Dl]
        return x if sbuf is None else (x.float() * sbuf[i, :, :, :S, None]).to(torch.bfloat16)
    views = [(rows(cache.k, cache.k_scale, i), rows(cache.v, cache.v_scale, i))
             for i in range(L)]
    mask = (torch.arange(S, device=dev)[None, :] < kl[:, None])[:, None, None, :]
    qs = q.reshape(B, KVh * rep, 1, Dl)
    lib = graph_ms(lambda: [torch.nn.functional.scaled_dot_product_attention(
        qs, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in views]) / L
    # each valid row's Dl logical columns of K and V (and an int8 row's two
    # scales), q and the output
    elem = cache.k.element_size() + (4 / Dl if cache.quantized else 0)
    nbytes = 2 * KVh * sum(lens) * Dl * elem + 2 * q.numel() * 2
    bound = card.bound_ms(nbytes, 4 * KVh * rep * sum(lens) * Dl, card.bf16_peak)
    return ms, plain, bound, lib


def k2_batch_check(card, cfg, cache, lens):
    """K2 (K6 on an int8 cache) against its plain version on an engine's
    cache at per-slot lengths lens, every layer, bit for bit: worst abs
    error."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    KVh, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q = card.bf16(len(lens), KVh, rep, cfg.head_dim)
    kl = torch.tensor(lens, dtype=torch.int32, device=card.dev)
    kw = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    worst = 0.0
    for i in range(cfg.num_layers):
        li = torch.tensor([i], dtype=torch.int32, device=card.dev)
        got = ak.flash_decode(q, cache.k, cache.v, kl, li, **kw)
        want = ak.flash_decode_plain(q, cache.k, cache.v, kl, li, **kw)
        if not torch.equal(got, want):
            raise AssertionError(f"K2/K6 at B = {len(lens)}, layer {i}: "
                                 f"{float((got.float() - want.float()).abs().max())}")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    return worst


def sse_ids(port, body):
    """POST a streaming /v1/completions: the ids of its events, in order,
    and its last event."""
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    return [t for e in events for t in e["ids"]], events[-1]


def post_json(port, path, body=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def serve_http(eng, prompts, want):
    """serve_async over the engine on 127.0.0.1 (a free port) with the
    synthetic tokenizer: GET /health, 4 client threads POSTing
    /v1/completions (two streaming) for prompts, GET /v1/stats; each
    reply's ids must equal want's (the engine's ids for the same prompt
    and budget).  -> the phase's record."""
    import threading
    from tmac_tpu_torch.runtime.server import serve_async
    httpd, serving = serve_async(eng, port=0, tokenizer=synthetic_tokenizer(eng.cfg.vocab_size))
    port = httpd.server_address[1]
    out, errors = {}, []
    try:
        health = post_json(port, "/health")

        def client(i):
            body = dict(prompt_ids=prompts[i], max_tokens=len(want[i]))
            try:
                if i % 2:
                    ids, last = sse_ids(port, dict(body, stream=True))
                    out[i] = dict(ids=ids, finish_reason=last.get("finish_reason"),
                                  stream=True)
                else:
                    r = post_json(port, "/v1/completions", body)
                    out[i] = dict(ids=r["ids"], finish_reason=r["finish_reason"],
                                  text=r.get("text", "")[:40], stream=False)
            except Exception as e:  # noqa: BLE001 -- reported and failed below
                errors.append(f"client {i}: {type(e).__name__}: {e}")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        alive = [t.is_alive() for t in threads]
        stats = post_json(port, "/v1/stats")
    finally:
        serving.shutdown()
        httpd.shutdown()
        httpd.server_close()
    equal = [out.get(i, {}).get("ids") == want[i] for i in range(len(prompts))]
    rec = dict(port=port, health=health, clients=len(prompts), wall_s=wall,
               replies={i: dict(v, ids=v["ids"][:8]) for i, v in out.items()},
               ids_equal_engine=equal, errors=errors,
               stats_prefills=stats.get("prefills"), threads_alive=alive)
    if errors or any(alive) or not all(equal) or not health.get("ok"):
        raise AssertionError(f"engine_serve http: {rec}")
    return rec


def engine_serve(card, cfg, params, model):
    """The phase engine_serve on Qwen2-7B W4A16 g128 at full width and depth
    (the path's weights and model), each check gating the exit code:
    - an InferenceEngine of SERVE_ENGINE, warmed up (every prefill bucket,
      the base decode graph), drives the serving bench (SERVE_REQUESTS
      requests, Poisson arrivals), its launches counted against its
      prefill chunks by bucket and its decode steps;
    - the decode step at 8 active slots, at KV lengths of ~80-200 rows and
      of ~1000: device ms from the engine's CUDA events, host ms a chunk
      outside the replays; one step of the 8 live slots (short lengths)
      against the plain versions;
    - the prefix cache on an engine whose chunks all take the 512-row
      bucket: the shared-prefix prompts' hits give their cold streams;
    - a mixed batch through submit/step on a cold engine without the
      prefix cache (seeded and unseeded sampled requests, a seed again
      beside other partners and in another slot, a seeded greedy one,
      logprobs, stop tokens, an eos id, a cancel after the first chunk),
      its greedy streams the warmed engine's;
    - an int8 cache (K6); the HTTP server over the cold engine;
    - the engine against the single-stream path: prefill_slot against
      generate's prefill bit for bit (prefill_slot_check), and the witness
      streams (single_stream_check, bf16 and int8 caches): on the
      engine's own 8-row plans reported, in the one-row forms every stream
      generate()'s token for token, its KV rows the single stream's bit
      for bit, each token the argmax of its teacher-forced row and the
      logprob records within LOGPROB_TOL of their log-softmax;
    - K4, K1 and K2 (K6) at B = 8 against their plain versions, and per
      step beside B = 1 and their bounds.
    -> the kernels' records at B = 8."""
    import numpy as np
    import torch
    from tmac_tpu_torch.runtime.bench_serve import run_serve_bench
    from tmac_tpu_torch.runtime.engine import InferenceEngine
    t_phase = time.perf_counter()

    def report(phase, **kw):
        say(f"engine_serve_{phase}", at_s=time.perf_counter() - t_phase, **kw)
    L, V, head = cfg.num_layers, cfg.vocab_size, params["lm_head"]
    # the warm-up and the bench, the launches counted over both
    eng = InferenceEngine(model, **SERVE_ENGINE)
    before = engine_counters(eng)
    zero_counts()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm = dict(seconds=time.perf_counter() - t0, graph_captures=eng.stats["graph_captures"],
                capture_s=eng.stats["capture_s"], stats_kept=eng.stats["prefills"] == 0)
    prompts, budgets = serve_traffic(V, SERVE_REQUESTS, 700, 32, 96, SERVE_SHARED)
    bench = run_serve_bench(eng, prompts, budgets, SERVE_RATE, seed=0)
    torch.cuda.synchronize()
    got = read_counts()
    after = engine_counters(eng)
    calls, launched, step = engine_run_launches(cfg, params, before, after, False,
                                                warm_buckets=eng.buckets)
    streams = [eng.finished[u].output for u in bench["uids"]]
    bench_ok = dict(
        launches=got == calls,
        path_kernels_counted=all(got[k] > 0 for k in ("K4", "K1", "K2"))
        and all(got[k] > 0 for k, n in calls.items() if n),
        lengths=[len(s) for s in streams] == budgets,
        reasons=all(eng.finished[u].finish_reason == "length" for u in bench["uids"]),
        in_range=all(0 <= t < V for s in streams for t in s))
    report("bench", model=cfg.name, engine=SERVE_ENGINE, rate=SERVE_RATE,
           prompt_lens=[len(p) for p in prompts], budgets=budgets,
           **{k: v for k, v in bench.items() if k != "uids"},
           prefix_hits=eng.stats["prefix_hits"],
           prefix_tokens_reused=eng.stats["prefix_tokens_reused"],
           prefill_chunks=after["prefill_chunks"], warmup=warm,
           chunks=after["chunks"] - before["chunks"],
           graph_replays=after["graph_replays"] - before["graph_replays"],
           eager_steps=after["eager_steps"] - before["eager_steps"],
           launches_counted=got, launches_expected=calls, launched_on_card=launched,
           launches_per_step=step, checks=bench_ok, card=card.name, nvidia_smi=card.smi)
    if not all(bench_ok.values()):
        raise AssertionError(f"engine_serve bench: {bench_ok}")

    # the decode step at 8 active slots, on the engine's own CUDA events,
    # at short KV lengths (16-token prompts) and at about 1000 rows
    def decode_at_8(prompts8):
        """The 8 prompts' requests decoding in all 8 slots, then two ticks
        timed -> (the record, the uids, the slots' KV lengths)."""
        uids = [eng.submit(p, max_new_tokens=SERVE_ENGINE["max_len"] - len(p) - 1)
                for p in prompts8]
        while eng.waiting or any(r is not None and (r.prefilling or not r.output)
                                 for r in eng.slots):
            eng.step()
        if any(r is None for r in eng.slots):
            raise AssertionError("engine_serve: a slot emptied before all 8 were active")
        lens = (eng.cache.pos + 1).tolist()
        c0 = engine_counters(eng)
        for _ in range(2):
            eng.step()
        c1 = engine_counters(eng)
        replays = c1["graph_replays"] - c0["graph_replays"]
        chunks = c1["chunks"] - c0["chunks"]
        rec = dict(step_ms=(c1["replay_ms"] - c0["replay_ms"]) / replays, replays=replays,
                   chunks=chunks, eager_steps=c1["eager_steps"] - c0["eager_steps"],
                   host_ms_per_chunk_outside_replays=(
                       (c1["decode_s"] - c0["decode_s"]) * 1e3
                       - (c1["replay_ms"] - c0["replay_ms"])) / chunks,
                   kv_lens=lens)
        rec["tokens_per_s"] = 8e3 / rec["step_ms"]
        return rec, uids, lens
    at8, uids, lens8 = decode_at_8([p[:16] for p in prompts[:8]])
    # the 8 live slots' next step against the plain versions
    plain = llama_in_mode(cfg, params, "explicit", plain=True)
    at8["plain_max_nmse"], at8["plain_min_agreement"] = plain_batch_step(model, plain, eng)
    del plain
    for u in uids:
        eng.cancel(u)
    rng = np.random.default_rng(4)
    at8["at_1000_rows"], uids, lens_long = decode_at_8(
        [rng.integers(0, V, int(n)).tolist() for n in rng.integers(900, 1001, 8)])
    for u in uids:
        eng.cancel(u)
    STEP_MS["qwen2_engine"] = dict(replayed_step_at_8_slots=at8["step_ms"],
                                   replayed_step_at_8_slots_1000_rows=at8["at_1000_rows"][
                                       "step_ms"],
                                   bench_aggregate_tokens_per_s=bench["aggregate_tok_s"])
    report("step_at_8", **at8, card=card.name, nvidia_smi=card.smi)
    if at8["plain_max_nmse"] > PATH_NMSE or at8["plain_min_agreement"] < 1.0:
        raise AssertionError(f"engine_serve: 8 slots against the plain versions: {at8}")

    # the prefix cache, route for route: an engine whose prefill chunks
    # all take the 512-row bucket, so that a hit's remainder chunk runs the
    # kernels of the cold chunk it replaces (in SERVE_ENGINE's buckets the
    # remainder after a 256-token match takes the 256-row bucket, K4L on
    # int8 activations, where the cold chunk took K5 on bf16 ones: another
    # rounding of the same function).  The four shared-prefix prompts
    # together (admitted in one tick: cold), then the first alone and the
    # other three together (each a hit): every stream the cold one's
    G = streams
    shared = list(range(SERVE_REQUESTS - SERVE_SHARED, SERVE_REQUESTS))
    pe = InferenceEngine(model, **dict(SERVE_ENGINE,
                                       prefill_buckets=[SERVE_ENGINE["prefill_chunk"]]))
    runs = []
    for groups in ([shared], [shared[:1], shared[1:]]):
        hits, out = pe.stats["prefix_hits"], {}
        for group in groups:
            us = {i: pe.submit(prompts[i], max_new_tokens=budgets[i]) for i in group}
            pe.run()
            out.update({i: pe.finished[u].output for i, u in us.items()})
        runs.append((out, pe.stats["prefix_hits"] - hits))
    prefix = dict(cold_hits=runs[0][1], hits=runs[1][1],
                  tokens_reused=pe.stats["prefix_tokens_reused"],
                  streams_equal_cold={i: runs[1][0][i] == runs[0][0][i] for i in shared},
                  bench_hits=eng.stats["prefix_hits"],
                  bench_tokens_reused=eng.stats["prefix_tokens_reused"],
                  cold_streams_equal_bench={i: runs[0][0][i] == G[i] for i in shared},
                  graph_captures=pe.stats["graph_captures"], capture_s=pe.stats["capture_s"])
    del pe
    report("prefix", **prefix)
    if (prefix["cold_hits"] or prefix["hits"] != SERVE_SHARED
            or not all(prefix["streams_equal_cold"].values())):
        raise AssertionError(f"engine_serve prefix cache: {prefix}")

    # the mixed batch through submit and step, on a cold engine without
    # the prefix cache (a prompt sent again to one with it may hit its own
    # block, whose remainder chunk takes other kernels): its greedy streams
    # must be the warmed engine's bench streams of the same prompts (the
    # first 12, which share no prefix: cold there too)
    mix = InferenceEngine(model, **dict(SERVE_ENGINE, prefix_cache_size=0))

    def cut_at(seq, stop):
        j = next(j for j in range(len(seq)) if seq[j:j + len(stop)] == stop)
        return seq[:j]
    mixed = {
        "seeded_a": (2, dict(max_new_tokens=24, seed=11, **SERVE_SAMPLED)),
        "seeded_b": (3, dict(max_new_tokens=24, seed=22, **SERVE_SAMPLED)),
        "sampled": (4, dict(max_new_tokens=24, **SERVE_SAMPLED)),
        "logprobs": (0, dict(max_new_tokens=24, logprobs=4)),
        "stop": (1, dict(max_new_tokens=32, stop_tokens=[G[1][5:7]])),
        "eos": (5, dict(max_new_tokens=32, eos_id=G[5][4])),
        "cancelled": (6, dict(max_new_tokens=64)),
    }
    before = engine_counters(mix)
    zero_counts()
    mu = {k: mix.submit(prompts[i], **kw) for k, (i, kw) in mixed.items()}
    cancelled_at = None
    while mix.pending():
        mix.step()
        r = mix.request(mu["cancelled"])
        if cancelled_at is None and r is not None and len(r.output) > 1:
            cancelled_at = len(r.output)
            cancel_ok = mix.cancel(mu["cancelled"])
    # round 2: the seed again beside other partners, in another slot; a
    # seeded request at temperature 0
    again = [mix.submit(prompts[7], max_new_tokens=24),
             mix.submit(prompts[8], max_new_tokens=24, **SERVE_SAMPLED),
             mix.submit(prompts[2], max_new_tokens=24, seed=11, **SERVE_SAMPLED),
             mix.submit(prompts[9], max_new_tokens=24, temperature=0.0, seed=5)]
    mix.run()
    torch.cuda.synchronize()
    got = read_counts()
    after = engine_counters(mix)
    mcalls, mlaunched, _ = engine_run_launches(cfg, params, before, after, False)
    out = {k: mix.finished[u] for k, u in mu.items() if u in mix.finished}
    lp = out["logprobs"]
    mixed_ok = dict(
        launches=got == mcalls,
        seed_repeats=mix.finished[again[2]].output == out["seeded_a"].output,
        seeds_differ=out["seeded_a"].output != out["seeded_b"].output,
        seeded_greedy=mix.finished[again[3]].output == G[9][:24],
        sampled_in_range=all(0 <= t < V for k in ("seeded_a", "seeded_b", "sampled")
                             for t in out[k].output),
        partner_greedy=mix.finished[again[0]].output == G[7][:24],
        logprobs_stream=lp.output == G[0][:24] and len(lp.logprobs_out) == 24,
        stop=out["stop"].output == cut_at(G[1], G[1][5:7])
        and out["stop"].finish_reason == "stop",
        eos=out["eos"].output == G[5][:G[5].index(G[5][4]) + 1]
        and out["eos"].finish_reason == "eos",
        cancelled=cancelled_at is not None and cancel_ok and mu["cancelled"] not in out)
    report("mixed", requests={k: dict(prompt=i, **{a: b for a, b in kw.items()
                                                    if a != "stop_tokens"})
                              for k, (i, kw) in mixed.items()},
           tokens={k: r.output[:8] for k, r in out.items()}, cancelled_after=cancelled_at,
           graph_captures=mix.stats["graph_captures"], capture_s=mix.stats["capture_s"],
           launches_counted=got, launches_expected=mcalls, launched_on_card=mlaunched,
           checks=mixed_ok)
    if not all(mixed_ok.values()):
        raise AssertionError(f"engine_serve mixed batch: {mixed_ok}")

    # the int8 cache (K6)
    q8 = InferenceEngine(model, **dict(SERVE_ENGINE, kv_quant=True, prefix_cache_size=0))
    p8, b8 = serve_traffic(V, SERVE_INT8, 300, 16, 48, seed=1)
    before = engine_counters(q8)
    zero_counts()
    u8 = [q8.submit(p, max_new_tokens=b) for p, b in zip(p8, b8)]
    q8.run()
    torch.cuda.synchronize()
    got = read_counts()
    calls8, launched8, _ = engine_run_launches(cfg, params, before, engine_counters(q8), True)
    s8 = [q8.finished[u].output for u in u8]
    lens_q8 = (q8.cache.pos + 1).tolist()
    int8_ok = dict(launches=got == calls8, k6_counted=got["K6"] > 0,
                   lengths=[len(s) for s in s8] == b8)
    report("int8", launches_counted=got, launches_expected=calls8,
           launched_on_card=launched8, checks=int8_ok)
    if not all(int8_ok.values()):
        raise AssertionError(f"engine_serve int8 cache: {int8_ok}")

    # the HTTP server over the engine
    http = serve_http(mix, prompts[8:12], [G[i] for i in range(8, 12)])
    report("http", **http)

    # the engine against the single-stream path: slot prefill against
    # generate's prefill, bit for bit; the witness streams on the engine's
    # own plans (reported) and in the one-row forms (every stream equal)
    rng = np.random.default_rng(3)
    pre = [prefill_slot_check(model, rng.integers(0, V, n).tolist(), 5, quant)
           for n, quant in ((256, False), (16, False), (256, True))]
    single = {"bf16": single_stream_check(model, False),
              "int8": single_stream_check(model, True)}
    one = [v["one_row"] for v in single.values()]
    ss_ok = dict(prefill_slot=all(r["ok"] for r in pre),
                 streams=all(r["tokens_equal_generate"] == r["kv_rows_equal"]
                             == r["argmax_every_token"] == r["streams"] for r in one),
                 logprobs=all(r["logprob_max_abs_err"] <= LOGPROB_TOL for r in one))
    differ, rows = norm_rows_differing(model)
    report("single_stream", prefill_slot=pre, **single, logprob_tol=LOGPROB_TOL,
           final_norm_rows_differing_8_vs_1=differ, final_norm_rows=rows, checks=ss_ok)
    if not all(ss_ok.values()):
        raise AssertionError(f"engine_serve single stream: {ss_ok}")

    # K4, K1 and K2 (K6) at B = 8 against their plain versions; per step
    # beside B = 1 and the bounds
    layers = params["layers"]
    k4_rows, _ = check_k4(card, [(sh, *linear_call(card, cfg, sh, 8, layers[0], folds))
                                 for sh in LINEARS for folds in (True, False)], splits=(None,))
    k4_err = max(r["max_abs_err"] for r in k4_rows)
    k1_rows, k1_err = check_k1(card, [("head", card.bf16(8, cfg.hidden_size), head, {})],
                               splits=(None,))
    k2_err = k2_batch_check(card, cfg, eng.cache, lens8)
    k6_err = k2_batch_check(card, cfg, q8.cache, lens_q8)
    _, k4_8 = per_linear_times(card, cfg, layers, 8, time_k4, L)
    _, k4_1 = per_linear_times(card, cfg, layers, 1, time_k4, L)
    h8, h1 = time_head(card, head, 8), time_head(card, head, 1)
    k2_8 = time_k2_batch(card, cfg, eng.cache, lens8)
    k2_8_long = time_k2_batch(card, cfg, eng.cache, lens_long)
    one = dataclasses.replace(eng.cache, k=eng.cache.k[:, :1].contiguous(),
                              v=eng.cache.v[:, :1].contiguous(), pos=eng.cache.pos[:1])
    k2_1 = time_k2_batch(card, cfg, one, lens8[:1])
    del one
    k6_8 = time_k2_batch(card, cfg, q8.cache, lens_q8)

    def t(v):
        return dict(ms=v[0], plain_ms=v[1], bound_ms=v[2], library_ms=v[3])
    per_step = dict(
        K4_B8=dict(k4_8, calls=4 * L), K4_B1=dict(k4_1, calls=4 * L),
        K1_B8=t(h8), K1_B1=t(h1), K2_B8={k: L * v for k, v in t(k2_8).items()},
        K2_B1={k: L * v for k, v in t(k2_1).items()},
        K2_B8_1000_rows={k: L * v for k, v in t(k2_8_long).items()},
        K6_B8={k: L * v for k, v in t(k6_8).items()},
        kv_lens_B8=lens8, kv_lens_B1=lens8[:1], kv_lens_B8_1000_rows=lens_long,
        kv_lens_int8=lens_q8)
    report("kernels", per_step=per_step, k4_checks=k4_rows, k1_checks=k1_rows,
           k2_max_abs_err=k2_err, k6_max_abs_err=k6_err, card=card.name,
           nvidia_smi=card.smi)
    src = "tmac_tpu_torch/ops/cuda/csrc/"
    total = {k: launched[k] + mlaunched[k] + launched8[k] for k in COUNTERS}

    def rec(name, source, replaces, label, err, tm):
        return dict(name=name, path="qwen2-7b engine, B = 8", route="cuda",
                    source=src + source, replaces="tmac_tpu/ops/pallas/" + replaces,
                    launches=total[label], max_abs_err=err, ms=tm["ms"],
                    plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"], bound_by="bytes",
                    library_ms=tm["library_ms"])
    records = [
        rec("qgemm_grouped (K4) bits 4, B = 8", "qgemm_grouped.cu", "qgemm_kernel.py:567",
            "K4", k4_err, k4_8),
        rec("qgemm_fused (K1) int8 head, B = 8", "qgemm_fused.cu", "qgemm_kernel.py:567",
            "K1", k1_err, t(h8)),
        rec("flash_decode (K2) rep 7, B = 8", "flash_decode.cu", "attention_kernel.py:367",
            "K2", k2_err, per_step["K2_B8"]),
        rec("flash_decode_split (K6) rep 7 int8, B = 8", "flash_decode.cu",
            "attention_kernel.py:367", "K6", k6_err, per_step["K6_B8"]),
    ]
    del eng, q8, mix
    say("engine_serve", seconds=time.perf_counter() - t_phase, card=card.name,
        nvidia_smi=card.smi)
    return records


# K4's ags form checked at every bits on a weight of Llama-2-7B's wo shape;
# path 7's activation group size
AGS_SIZES, AGS_ROWS, AGS_PATH = (32, 64), (1, 4, 16), 32


def ags_path(card):
    """Path 7: Llama-2-7B W2 g128 with zero points and act_group_size 32
    (grouped_path; weights drawn on the card): a 768-token prompt in chunks
    of 512 (K5, where the reference keeps float activations) and 256 (K4L's
    ags form), 64 steps at positions 768-831 (K4's ags form, K1, K2).
    -> the kernels' records"""
    from tmac_tpu_torch.models.config import get_preset
    cfg = dataclasses.replace(get_preset("llama-2-7b").with_quant(act_group_size=AGS_PATH),
                              num_layers=AGS_LAYERS)
    return grouped_path(card, "llama2_ags32", cfg, W3_PROMPT, W3_CHUNK)


def k4_ags_bits_check(card):
    """K4's ags form at bits 1, 2, 3 and 4 (ags 32 and 64, N = 1, 4 and 16)
    on a 4096 x 4096 weight drawn on the card (gs 128), through check_k4:
    without folds bit for bit with the prologue's codes, per-activation-
    group scales and weight groups' code sums byte for byte, at its
    cluster sizes; with wo's residual bit for bit.  -> (rows, worst)"""
    import torch
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(13)
    rows, worst = [], 0.0
    for bits in (1, 2, 3, 4):
        qt = rand_qt_on_card(gen, 4096, 4096, bits, 128, card.dev)
        cases = []
        for ags in AGS_SIZES:
            for N in AGS_ROWS:
                cases += [(f"4096 x 4096 w{bits}", card.bf16(N, 4096), qt, dict(act_gs=ags)),
                          (f"4096 x 4096 w{bits}", card.bf16(N, 4096), qt,
                           dict(act_gs=ags, residual=card.bf16(N, 4096)))]
        r, err = check_k4(card, cases)
        rows += r
        worst = max(worst, err)
        del qt
    return rows, worst


def wa8_k7_checks(card, cfg, gu0, dn0):
    """K7's per-tensor branch on the path's own stacks (gate_up 4096 x 28672
    on a shared bf16 row, down 14336 x 4096 with the SwiGLU prologue on each
    expert's f32 rows) at N = 1 and 4, and on 4-expert stacks at the same
    shapes drawn on the card: per-tensor at bits 1 and 4 (pt_qt_on_card,
    nonzero zero points) and grouped at bits 1 (g128), through check_k7
    (every expert alone, routes of two covering every expert, one at
    cluster sizes 1 and 8): bit for bit.  Each 4-expert stack's forms then
    timed as time_k7_step times a Mixtral step, over 32 calls whose routes
    rotate through the stack (its 4 experts exceed the 50 MB L2 at bits 4
    and come close at bits 1).  -> (rows, worst, {form: (rows, per 32 calls)})"""
    import torch
    from tmac_tpu_torch.models.moe import stack_experts
    from tmac_tpu_torch.ops.qgemm import fuse_m
    H, Ie, E = gu0.kdim, dn0.kdim, 4
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(7)
    stacks = [(gu0, dn0, gu0.packed.shape[0])]
    for bits, gs in ((1, 0), (4, 0), (1, 128)):
        def draw(K, M):
            return (rand_qt_on_card(gen, K, M, bits, gs, card.dev) if gs
                    else pt_qt_on_card(gen, K, M, bits, card.dev))
        stacks.append((stack_experts([fuse_m([draw(H, Ie), draw(H, Ie)]) for _ in range(E)]),
                       stack_experts([draw(Ie, H) for _ in range(E)]), E))
    rows, worst, times = [], 0.0, {}
    four = dataclasses.replace(cfg, num_experts=E)
    for gu, dn, n in stacks:
        form = "grouped" if gu.scales.shape[-2] > 1 else "per-tensor"
        cases = []
        for N in (1, 4):
            cases += [(f"gate_up {form}", card.bf16(1, N, H), gu, False),
                      (f"down {form}", card.bf16(n, N, 2 * Ie).float(), dn, True)]
        r, err = check_k7(card, cases)
        rows += r
        worst = max(worst, err)
        if n == E:
            times[f"bits {gu.bits} {form}"] = time_k7_step(
                card, four, [{"experts_gate_up": gu, "experts_down": dn}] * 32)
    del stacks
    torch.cuda.empty_cache()
    return rows, worst, times


def mixtral_wa8_path(card):
    """Path 8: Mixtral-8x7B's architecture (32 layers, hidden 4096, 8
    experts top-2 of FFN 14336, 32 heads over 8 KV heads, vocab 32000) at
    w_a8 bits 2, ternary per-tensor weights drawn on the card (seed 0; the
    experts' codes 11.3 GB): K7's per-tensor branch checks (and its bits 1
    and 4 forms, wa8_k7_checks), K1 and K3 on its linears and head, K2;
    then run_path's main run: a 256-token prefill, whose MoE layers take
    the capacity dispatch form with every expert's 128 slots on K3, and 64
    select steps (K7's per-tensor branch for both routed experts, one call
    for gate_up and one for down a layer, K1 on wqkv, wo and the head, K2
    at rep 4), teacher-forced on every position; each kernel's device time
    per step or prefill.  -> the kernels' records"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.moe import expert_capacity, expert_view
    t_path = time.perf_counter()
    cfg = get_preset("mixtral-8x7b").with_quant(mode="w_a8", group_size=-1, bits=2)
    params = params_on_card(cfg, 0, card.dev)
    torch.cuda.synchronize()
    layers, head = params["layers"], params["lm_head"]
    H, L, E, eps = cfg.hidden_size, cfg.num_layers, cfg.num_experts, cfg.rms_norm_eps
    l0 = layers[0]
    gu0, dn0 = l0["experts_gate_up"], l0["experts_down"]
    Ie, C = dn0.kdim, expert_capacity(LLAMA_PROMPT, cfg)
    say("mixtral_wa8_build", init_params_s=round(time.perf_counter() - t_path, 3),
        mode=cfg.quant.mode, bits=cfg.quant.bits, layers=L, experts=E,
        expert_code_gb=round(L * (gu0.packed.numel() + dn0.packed.numel()) / 1e9, 3),
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    k7_rows, k7_err, k7_forms = wa8_k7_checks(card, cfg, gu0, dn0)
    say("k7_check_wa8", at_s=round(time.perf_counter() - t_path, 3), checks=k7_rows,
        times={f: dict(rows=r, per_32_calls=t) for f, (r, t) in k7_forms.items()},
        card=card.name, nvidia_smi=card.smi)

    # the path's linears: (x, weight, folds) at N rows
    def lin(shape, N, layer, e=None):
        if shape == "wqkv":
            return card.bf16(N, H), layer["wqkv"], dict(norm=(layer["attn_norm"], eps))
        if shape == "wo":
            return card.bf16(N, cfg.q_dim), layer["wo"], dict(residual=card.bf16(N, H))
        if shape == "gate_up":
            return card.bf16(N, H), expert_view(layer["experts_gate_up"], e), {}
        if shape == "down":
            return card.bf16(N, 2 * Ie), expert_view(layer["experts_down"], e), dict(glu=True)
        return card.bf16(N, H), head, {}
    k1_cases = [(sh, *lin(sh, N, l0, 3)) for sh in ("wqkv", "wo", "head") for N in (1, 4)]
    k1_cases += [(sh, x[:, :w.kdim].contiguous(), w, {}) for sh, x, w, _ in k1_cases[:4]]
    k1_rows, k1_err = check_k1(card, k1_cases)
    k3_rows, k3_err = check_k3(card, [(sh, *lin(sh, n, l0, 5)) for sh, n in (
        ("wqkv", LLAMA_PROMPT), ("wo", LLAMA_PROMPT), ("gate_up", C), ("down", C),
        ("head", LLAMA_PROMPT))])
    k2_rows, k2_err = check_k2_heads(card, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                                     cfg.head_dim)
    say("k1_k3_k2_check_wa8", at_s=round(time.perf_counter() - t_path, 3), k1=k1_rows,
        k3=k3_rows, k2=k2_rows)

    # prefill: wqkv and wo at 256 rows, every expert's gate_up and down at
    # its C slots, the head (K3); a step: K1 on wqkv, wo and the head, one K7
    # call for the 2 routed experts' gate_up and one for their down a layer
    main = run_path(card, "mixtral_wa8", cfg, params, LLAMA_PROMPT,
                    counts(K3=(2 + 2 * E) * L + 1),
                    counts(K1=2.0 * L + 1, K7=2.0 * L, K2=float(L)), forced=MOE_FORCED)
    launches = main["launches"]

    k7_times, k7_tot = time_k7_step(card, cfg, layers)
    say("k7_times_wa8", at_s=round(time.perf_counter() - t_path, 3), rows=k7_times,
        per_step=dict(k7_tot, calls=2 * L), card=card.name, nvidia_smi=card.smi)
    k1_rows, k1_tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for sh in ("wqkv", "wo"):
        k1_rows.append(dict(shape=sh, per_step=L, **time_k4(
            card, [lin(sh, 1, layers[i]) for i in range(L)])))
        for key in k1_tot:
            k1_tot[key] += L * k1_rows[-1][key]
    h_ms, h_plain, h_bound, h_lib = time_head(card, head)
    for key, val in (("ms", h_ms), ("plain_ms", h_plain), ("bound_ms", h_bound),
                     ("library_ms", h_lib)):
        k1_tot[key] += val
    say("k1_times_wa8", rows=k1_rows, head=dict(ms=h_ms, plain_ms=h_plain, bound_ms=h_bound,
                                                 library_ms=h_lib),
        per_step=dict(k1_tot, calls=2 * L + 1))
    k3_rows, k3_tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for sh, n, count in (("wqkv", LLAMA_PROMPT, L), ("wo", LLAMA_PROMPT, L),
                         ("gate_up", C, E * L), ("down", C, E * L), ("head", LLAMA_PROMPT, 1)):
        calls = [lin(sh, n, l0 if sh in ("gate_up", "down") else layers[i], i)
                 for i in range(1 if sh == "head" else 4)]
        row = time_k3(card, calls)
        k3_rows.append(dict(shape=sh, per_prefill=count, **row))
        for key in k3_tot:
            k3_tot[key] += count * row[key]
    say("k3_times_wa8", rows=k3_rows, per_prefill=dict(k3_tot, calls=(2 + 2 * E) * L + 1),
        card=card.name, nvidia_smi=card.smi)
    kv_len = LLAMA_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, main["cache"], kv_len)
    say("mixtral_wa8_step", eager_ms=main["step_ms"], graph_ms=main["graph_step_ms"],
        decode_loop_ms=main["loop_ms"],
        kernel_bound_ms=k7_tot["bound_ms"] + k1_tot["bound_ms"] + k2_bound * L,
        kv_len=kv_len, k2_ms=k2_ms, k2_plain_ms=k2_plain, k2_bound_ms=k2_bound,
        k2_library_ms=k2_lib, card=card.name, nvidia_smi=card.smi,
        path_s=round(time.perf_counter() - t_path, 3))
    src = "tmac_tpu_torch/ops/cuda/csrc/"

    def rec(name, source, replaces, label, err, t, by):
        return dict(name=name, path="mixtral-8x7b-wa8", route="cuda", source=src + source,
                    replaces="tmac_tpu/ops/pallas/" + replaces, launches=launches[label],
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=by, library_ms=t["library_ms"])
    records = [
        rec("qgemm_experts (K7) per-tensor bits 2", "qgemm_expert.cu",
            "expert_kernel.py:207", "K7", k7_err, k7_tot, "bytes"),
        rec("qgemm_fused (K1)", "qgemm_fused.cu", "qgemm_kernel.py:567", "K1", k1_err,
            k1_tot, "bytes"),
        rec("qgemm_large_int (K3)", "qgemm_large.cu", "qgemm_kernel.py:266", "K3", k3_err,
            k3_tot, dominant_bound(k3_rows)),
        rec("flash_decode (K2) rep 4", "flash_decode.cu", "attention_kernel.py:367", "K2",
            k2_err, dict(ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
                         library_ms=k2_lib * L), "bytes"),
    ]
    del params, main, layers, head
    return records


@contextlib.contextmanager
def dequant_forward():
    """Every grouped linear of the model as bf16 activations times the bf16
    dequantized weights in f32 (K5's plain function, qgemm_dequant_plain,
    at every row count, no activation quantization); the per-tensor head
    as it is."""
    from tmac_tpu_torch.models import llama as tl
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k5
    saved = tl.kernel_for

    def kernel_for(qt, N, plain=False, dispatch=None, act_gs=0):
        if qt.scales.shape[0] > 1:
            return k5.qgemm_dequant_plain
        return saved(qt, N, plain, dispatch)
    tl.kernel_for = kernel_for
    try:
        yield
    finally:
        tl.kernel_for = saved


def ags_accuracy(card, cfg, params, prompt, chunk):
    """What the finer activation scales buy, printed, not gated: layer 0's
    four linears at 16 rows of N(0, 1) activations through K4 with the
    config's activation group size and at ags 0, each output's NMSE to the
    bf16 dequant product (qgemm_dequant_plain, no activation quantization);
    and the prompt's last position's logits at both (the kernel path,
    prefill in `chunk`-token pieces), each against a bf16 dequant forward
    of the same weights (dequant_forward), where 32 random layers amplify
    every rounding.  -> dict"""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k4
    from tmac_tpu_torch.ops.qgemm import kernel_for
    from tmac_tpu_torch.runtime.generate import prefill
    from tmac_tpu_torch.utils import argmax_agreement, nmse
    ags = cfg.quant.act_group_size
    linears = {}
    for name, qt in params["layers"][0].items():
        if name not in ("wqkv", "wo", "gate_up", "down"):
            continue
        x = card.bf16(16, qt.kdim)
        ref = k4.qgemm_dequant_plain(x, qt).cpu().numpy()
        linears[name] = {f"ags{a}": nmse(ref, kernel_for(qt, 16, act_gs=a)(x, qt).cpu().numpy())
                         for a in (ags, 0)}
    tokens = torch.from_numpy(prompt).to(card.dev)

    def last(c):
        model = llama_in_mode(c, params, "explicit")
        lg, _ = prefill(model, tokens, KVCache.create(c, 1, tokens.shape[1], device=card.dev),
                        chunk=chunk)
        return lg.float().cpu().numpy().reshape(-1)
    fine = last(cfg)
    coarse = last(cfg.with_quant(act_group_size=0))
    with dequant_forward():
        ref = last(cfg)
    return dict(act_group_size=ags, linear_nmse_vs_dequant=linears,
                prompt=int(tokens.shape[1]),
                nmse_vs_dequant=nmse(ref, fine), nmse_vs_dequant_ags0=nmse(ref, coarse),
                argmax_vs_dequant=argmax_agreement(ref, fine, TIE_MARGIN),
                argmax_vs_dequant_ags0=argmax_agreement(ref, coarse, TIE_MARGIN))


def graph_spread(card, own=3, shared=3, rounds=3, steps=32):
    """Llama-2-7B W2 at full size (init_params, seed 0), its decode
    step after a 1024-token prefill captured in `own` CUDA graphs, each on
    its own copy of the cache and token, and in `shared` more graphs on
    the first one's buffers; each graph timed `rounds` times in turns
    (`steps` replays from the prefill's position, ms per step), the card's
    clocks read each round; then decode_loop `rounds` times (ms per
    replayed step, setup seconds).  Whether the replays' speed belongs to
    a capture, to its buffers, or to the moment."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import KVCache, init_params
    from tmac_tpu_torch.runtime.generate import prefill
    from tmac_tpu_torch.runtime.sampling import sample
    cfg = get_preset("llama-2-7b")
    params = init_params(cfg, seed=0, device=card.dev)
    model = llama_in_mode(cfg, params, "explicit")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, LLAMA_LONG_PROMPT))).to(card.dev)
    cache = KVCache.create(cfg, 1, LLAMA_LONG_PROMPT + STEPS, device=card.dev)
    logits, cache = prefill(model, tokens, cache, chunk=LLAMA_CHUNK)
    first = sample(logits)
    bufs = [(clone_cache(cache), first.clone()) for _ in range(own)]
    bufs += [bufs[0]] * shared
    graphs = []
    for c, tok in bufs:
        pos0 = c.pos.clone()

        def step(c=c, tok=tok):
            lg, _ = model(tok[:, None], c)
            tok.copy_(sample(lg[:, -1]))
        graphs.append((capture(step), c, tok, pos0))
        c.pos.copy_(pos0)
        tok.copy_(first)
    ms = [[] for _ in graphs]
    clocks = []
    for _ in range(rounds):
        for i, (g, c, tok, pos0) in enumerate(graphs):
            c.pos.copy_(pos0)
            tok.copy_(first)
            ms[i].append(cuda_ms(g.replay, steps))
        clocks.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    del graphs
    loops = []
    for _ in range(rounds):
        _, st = loop_decode(model, first.clone(), clone_cache(cache))
        loops.append(dict(step_ms=st["step_ms"], setup_s=st["setup_s"]))
    return dict(model=cfg.name, prompt=LLAMA_LONG_PROMPT, steps=steps,
                graphs_own_buffers=ms[:own], graphs_on_first_buffers=ms[own:],
                clocks_sm_mem_power_temp=clocks, decode_loop=loops)


# ---------------------------------------------------------------------------
# path 10: speculative decoding on BitNet-3B (lookup; BitNet-700M as draft)
# ---------------------------------------------------------------------------

SPEC_PROMPT, SPEC_NEW, SPEC_K, SPEC_DRAFT_K, SPEC_NGRAM = 64, 192, 8, 4, 3
# The plain versions' runs (gate b) hold the kernel path to them over the
# first SPEC_PLAIN_NEW tokens of each run: K1's plain version is a float64
# matmul of the unpacked codes, ~0.3 s a 26-layer forward on the card.
# The eager rounds (gate a) run the lookup streams whole and the draft
# variants' first SPEC_EAGER_NEW tokens (an eager draft round launches
# five forwards from the host: ~6 tokens/s with the 700M draft).
SPEC_PLAIN_NEW, SPEC_EAGER_NEW = 8, 32
# the variants by prompt: lookup on both, the draft models on the periodic
SPEC_VARIANTS = {"periodic": ("lookup", "draft", "self"), "random": ("lookup",)}
SPEC_SAMPLER, SPEC_SEED = dict(temperature=0.8, top_p=0.95), 1
SPEC_ENGINE = dict(max_batch=1, max_len=512, decode_chunk=16)
SPEC_ENGINE_NEW, SPEC_ENGINE_SAMPLED_NEW = 128, 32


def spec_prompts(V):
    """The phase's two 64-token prompts: a 6-token pattern repeated, and
    random tokens."""
    import numpy as np
    rng = np.random.default_rng(15)
    periodic = np.tile(rng.integers(0, V, 6), SPEC_PROMPT // 6 + 1)[:SPEC_PROMPT]
    return {"periodic": periodic[None], "random": rng.integers(0, V, (1, SPEC_PROMPT))}


def spec_prefill(model, prompt, S):
    """The prompt's prefill on a fresh S-row cache: (its greedy first
    token (1,), the cache)."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.generate import prefill
    cache = KVCache.create(model.cfg, 1, S, device=model.device)
    logits, cache = prefill(model, torch.from_numpy(prompt).to(model.device), cache)
    return torch.argmax(logits.float(), -1).to(torch.int32), cache


def spec_run(variant, model, prompt, first, snap, steps, graph, draft=None,
             snap_d=None):
    """One greedy speculative decode of `steps` tokens (the first among
    them) from the prefill's cache snap (and the draft's snap_d): variant
    "lookup" (k = SPEC_K) or a draft model's (k = SPEC_DRAFT_K).  -> dict
    of the tokens, forwards, the run's stats and host seconds."""
    import torch
    from tmac_tpu_torch.runtime import speculative as sp
    hist = sp._history(torch.from_numpy(prompt).to(model.device), first, snap.max_len)
    st, T = {}, prompt.shape[1]
    t0 = time.perf_counter()
    if variant == "lookup":
        out, emitted, nf, _ = sp.decode_chunk_speculative(
            model, hist, T + 1, clone_cache(snap), steps, ngram=SPEC_NGRAM, k=SPEC_K,
            stats=st, graph=graph)
        nfd = 0
    else:
        out, emitted, nf, nfd, _, _ = sp.decode_chunk_draft_speculative(
            model, draft, hist, T + 1, clone_cache(snap), clone_cache(snap_d), steps,
            k=SPEC_DRAFT_K, stats=st, graph=graph)
    torch.cuda.synchronize()
    return dict(tokens=out[0].tolist(), emitted=emitted, nf=nf, nfd=nfd, stats=st,
                host_s=time.perf_counter() - t0)


def spec_round_launches(cfg_t, cfg_d, k):
    """The wrapper calls of one round: the target's k + 1 rows through K1
    (4 linears a layer and the head), and k one-token draft steps (K1 on
    each, K2 a layer)."""
    if cfg_d is None:
        return counts(K1=4 * cfg_t.num_layers + 1)
    return counts(K1=4 * cfg_t.num_layers + 1 + k * (4 * cfg_d.num_layers + 1),
                  K2=k * cfg_d.num_layers)


def spec_divergence(model, prompt, S, ref, got, k):
    """Where got (a speculative stream, the first token first) parts from
    ref (decode_loop's, or the plain engine's): the first index d that
    differs, and whether noise_gated_argmax gates it, with the logits of
    index d by ref's arithmetic (the prefill, then ref's tokens one at a
    time) as the reference and those of the same position by a (k + 1)-row
    forward (a verification's arithmetic) as the other sum order.  A gated
    divergence raises."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.generate import prefill
    d = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    if d is None:
        return dict(first_divergence=None)
    dev, seq = model.device, [int(t) for t in prompt[0]] + ref[:d]
    with torch.no_grad():
        cache = KVCache.create(model.cfg, 1, S, device=dev)
        ref_l, cache = prefill(model, torch.from_numpy(prompt).to(dev), cache)
        ref_l = ref_l[0]
        for t in ref[:d]:
            lg, cache = model(torch.tensor([[t]], device=dev), cache)
            ref_l = lg[0, -1]
        cache.pos.sub_(k + 1)
        lgm, _ = model(torch.tensor([seq[-(k + 1):]], device=dev), cache)
    ref_l, multi = ref_l.float(), lgm[0, -1].float()
    one = torch.zeros_like(ref_l)
    one[got[d]] = 1.0
    g = noise_gated_argmax(ref_l[None], one[None], multi[None])
    top2 = ref_l.topk(2).values
    row = dict(first_divergence=d, gated=g["gated_share"] > 0,
               ref_reproduced=int(ref_l.argmax()) == ref[d],
               lead=float(top2[0] - top2[1]), margin=g["median_margin"],
               noise_rms=float((ref_l - multi).pow(2).mean().sqrt()))
    if row["gated"] and g["gated_agreement"] < 1.0:
        raise AssertionError(f"a speculative stream parts from the reference at a "
                             f"gated position: {row}")
    return row


def spec_metrics(run, loop=None):
    """A run's acceptance, bursts, syncs and rates: tokens per
    verification forward, ms per replayed round and per burst (CUDA
    events), tokens/s on the host clock (prefill excluded) and from the
    replayed rounds' device time."""
    st = run["stats"]
    bursts = [a.elapsed_time(b) for a, b in st.get("replay_events", [])]
    new = run["emitted"] - 1
    row = dict(tokens=new, forwards=run["nf"], draft_forwards=run["nfd"],
               tokens_per_forward=new / max(run["nf"], 1), bursts=st["bursts"],
               host_syncs=st["host_syncs"], replays=st["replays"],
               eager_rounds=st["eager_rounds"], setup_s=st["setup_s"],
               tokens_per_s=new / run["host_s"])
    if st["replays"]:
        row.update(ms_per_round=sum(bursts) / st["replays"], ms_per_burst=bursts,
                   device_tokens_per_s=new / (sum(bursts) / st["replays"] * run["nf"]
                                              / 1e3))
    return row


def verify_split(card, cfg, params, model, cache, k):
    """A verification forward's device time (k + 1 rows; a CUDA graph)
    against a one-token step's, and its parts: K1 on the linears (4 a
    layer, 4 layers' weights a call as per_linear_times takes them, times
    the layers) and on the int8 head, the einsum attention (26 calls of
    the model's _prefill_attention), the rest as glue; torch.profiler's
    kernel split of the same forward."""
    import torch
    dev, L, T = card.dev, cfg.num_layers, k + 1
    pos0 = cache.pos.clone()
    feed = torch.randint(0, cfg.vocab_size, (1, T), device=dev)

    def fwd(n):
        def fn():
            cache.pos.copy_(pos0)
            model(feed[:, :n], cache)
        return fn
    verify_ms, step_ms = graph_ms(fwd(T)), graph_ms(fwd(1))
    launched = {}
    prof = profiled_ms(lambda: [fwd(T)() for _ in range(PROFILED)], PROFILED, launched)
    k1_rows, k1_tot = per_linear_times(card, cfg, params["layers"], T, time_k4, L)
    head = time_head(card, params["lm_head"], T)
    head_ms = head[0]
    q = card.bf16(1, T, cfg.num_heads, cfg.head_dim)
    positions = pos0[:, None].long() + torch.arange(T, device=dev)[None, :]
    mask = torch.arange(cache.max_len, device=dev)[None, :] < positions[:, -1:] + 1
    attn_ms = graph_ms(lambda: [model._prefill_attention(q, cache, li, positions, mask)
                                for li in range(L)])
    cache.pos.copy_(pos0)
    return dict(rows=T, kv_rows=int(pos0[0]), verify_ms=verify_ms, step_ms=step_ms,
                ratio=verify_ms / step_ms, k1_linears_ms=k1_tot["ms"], k1_head_ms=head_ms,
                einsum_attention_ms=attn_ms,
                glue_ms=verify_ms - k1_tot["ms"] - head_ms - attn_ms,
                profiler_ms=prof, profiler_launches=launched), (k1_rows, k1_tot, head)


def speculative_path(card):
    """Path 10 (the phase `speculative`): lookup and draft-model
    speculative decoding on BitNet-3B (weights drawn on the card, seed 0),
    BitNet-700M (seed 1) as the draft; K1 at 5 and 9 rows and K2 at the
    draft's head_dim 96 checked; gates (a) graph bursts == eager rounds,
    (b) kernel == plain versions, (c) a seed repeats, and each greedy
    stream noise-gated against decode_loop's (the engine's against the
    engine's without speculation).  -> the kernels' records."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.runtime.engine import InferenceEngine
    from tmac_tpu_torch.runtime.sampling import SamplerConfig
    from tmac_tpu_torch.runtime.speculative import generate_speculative, \
        generate_draft_speculative
    t_phase = time.perf_counter()
    cfg, cfg_d = get_preset("bitnet-3b"), get_preset("bitnet-700m")
    params = params_on_card(cfg, 0, card.dev)
    params_d = params_on_card(cfg_d, 1, card.dev)
    torch.cuda.synchronize()
    say("spec_init", seconds=round(time.perf_counter() - t_phase, 3))

    # (d) K1 at the verification's rows at both models' shapes, K2 at 96
    cases = []
    for c, p in ((cfg, params), (cfg_d, params_d)):
        for N in (SPEC_DRAFT_K + 1, SPEC_K + 1):
            for sh in LINEARS:
                x, qt, kw = linear_call(card, c, sh, N, p["layers"][0])
                cases += [(f"{c.name} {sh}", x, qt, kw),
                          (f"{c.name} {sh}", x[:, :qt.kdim].contiguous(), qt, {})]
            cases.append((f"{c.name} head", card.bf16(N, c.hidden_size), p["lm_head"], {}))
    k1_rows, k1_err = check_k1(card, cases)
    say("spec_k1_check", checks=k1_rows)
    k2_rows, k2_err = check_k2_heads(card, cfg_d.num_kv_heads, 1, cfg_d.head_dim)
    say("spec_k2_check", checks=k2_rows)

    model = llama_in_mode(cfg, params, "explicit")
    plain = llama_in_mode(cfg, params, "explicit", plain=True)
    draft = llama_in_mode(cfg_d, params_d, "explicit")
    draft_plain = llama_in_mode(cfg_d, params_d, "explicit", plain=True)
    prompts = spec_prompts(cfg.vocab_size)
    S = SPEC_PROMPT + SPEC_NEW + SPEC_K + 1
    L, Ld = cfg.num_layers, cfg_d.num_layers
    launched = {"K1 N=9": 0, "K1 N=5": 0, "K1 draft N=1": 0, "K2 draft": 0, "K3": 0}
    streams, agree_all = [], 0
    snaps = {}
    for pname, prompt in prompts.items():
        zero_counts()
        first, snap = spec_prefill(model, prompt, S)
        _, snap_d = spec_prefill(draft, prompt, S)
        got = read_counts()
        want = counts(K3=4 * L + 1 + 4 * Ld + 1)
        if got != want:
            raise AssertionError(f"spec prefill launches {got}, wanted {want}")
        launched["K3"] += got["K3"]
        pfirst, psnap = spec_prefill(plain, prompt, S)
        _, psnap_d = spec_prefill(draft_plain, prompt, S)
        if not (torch.equal(first, pfirst) and cache_bytes_equal(snap, psnap)
                and cache_bytes_equal(snap_d, psnap_d)):
            raise AssertionError(f"spec {pname}: the plain prefill differs")
        snaps[pname] = snap
        loop_toks, loop_st = loop_decode(model, first.clone(), clone_cache(snap),
                                         SPEC_NEW - 1)
        ref = [int(first[0])] + loop_toks
        eager_ms = eager_decode(model, first.clone(), clone_cache(snap), 32)[1]
        for variant in SPEC_VARIANTS[pname]:
            kw, pkw = {}, {}
            if variant == "draft":
                kw, pkw = dict(draft=draft, snap_d=snap_d), dict(draft=draft_plain,
                                                                 snap_d=psnap_d)
            elif variant == "self":
                kw, pkw = dict(draft=model, snap_d=snap), dict(draft=plain, snap_d=psnap)
            k = SPEC_K if variant == "lookup" else SPEC_DRAFT_K
            zero_counts()
            g = spec_run(variant, model, prompt, first, snap, SPEC_NEW, True, **kw)
            got = read_counts()
            st = g["stats"]
            calls = st["eager_rounds"] + int(st["captured"])
            per = spec_round_launches(cfg, None if variant == "lookup" else
                                      (cfg if variant == "self" else cfg_d), k)
            if got != {key: v * calls for key, v in per.items()} or not st["graph"] \
                    or not st["replays"]:
                raise AssertionError(f"spec {pname} {variant}: launches {got} for "
                                     f"{calls} rounds through the host, stats {st}")
            t_rows = (4 * L + 1) * calls
            if variant == "lookup":
                launched["K1 N=9"] += t_rows
            else:
                launched["K1 N=5"] += t_rows
                if variant == "draft":
                    launched["K1 draft N=1"] += got["K1"] - t_rows
                    launched["K2 draft"] += got["K2"]
            # (a) the graph's bursts against the same rounds run eagerly
            n_eager = SPEC_NEW if variant == "lookup" else SPEC_EAGER_NEW
            ge = g if n_eager == SPEC_NEW else spec_run(
                variant, model, prompt, first, snap, n_eager, True, **kw)
            e = spec_run(variant, model, prompt, first, snap, n_eager, False, **kw)
            # (b) the kernel path against the plain versions
            gk = spec_run(variant, model, prompt, first, snap, SPEC_PLAIN_NEW, True, **kw)
            gp = spec_run(variant, plain, prompt, pfirst, psnap, SPEC_PLAIN_NEW, False,
                          **pkw)
            div = spec_divergence(model, prompt, S, ref, g["tokens"], k)
            row = dict(prompt=pname, variant=variant, k=k,
                       graph_equals_eager=(ge["tokens"], ge["nf"]) == (e["tokens"], e["nf"]),
                       eager_tokens=n_eager,
                       kernel_equals_plain=(gk["tokens"], gk["nf"], gk["nfd"])
                       == (gp["tokens"], gp["nf"], gp["nfd"]),
                       plain_tokens=SPEC_PLAIN_NEW, launches=got, **div,
                       **spec_metrics(g), eager_tokens_per_s=(e["emitted"] - 1) / e["host_s"],
                       decode_loop_tokens_per_s=1e3 / loop_st["step_ms"],
                       decode_loop_tokens_per_s_with_capture=(SPEC_NEW - 1) / loop_st["host_s"],
                       decode_loop_eager_tokens_per_s=1e3 / eager_ms,
                       decode_loop_step_ms=loop_st["step_ms"], tokens_head=g["tokens"][:12],
                       at_s=round(time.perf_counter() - t_phase, 1))
            say("spec_run", **row)
            if not (row["graph_equals_eager"] and row["kernel_equals_plain"]):
                raise AssertionError(f"spec {pname} {variant}: {row}")
            streams.append(row)
            agree_all += div["first_divergence"] is None

    # sampling: both variants at temperature 0.8, top-p 0.95 on the
    # periodic prompt: (c) a seed repeats; (b) at one seed against the
    # plain versions (eager rounds on both sides)
    sampler = SamplerConfig(**SPEC_SAMPLER)
    prompt = prompts["periodic"]
    for variant in ("lookup", "draft"):
        def gen(m, d, n, seed, graph):
            st = {}
            t0 = time.perf_counter()
            if variant == "lookup":
                out, nf = generate_speculative(m, prompt, n, k=SPEC_K, ngram=SPEC_NGRAM,
                                               impl="xla" if m.plain else "auto",
                                               sampler=sampler, seed=seed, stats=st,
                                               graph=graph)
                nfd = 0
            else:
                out, nf, nfd = generate_draft_speculative(
                    m, d, prompt, n, k=SPEC_DRAFT_K, impl="xla" if m.plain else "auto",
                    sampler=sampler, seed=seed, stats=st, graph=graph)
            torch.cuda.synchronize()
            return out[0].tolist(), nf, nfd, st, time.perf_counter() - t0
        # (c) over the whole run for lookup; the draft variant (~60 tokens/s)
        # repeats its first SPEC_EAGER_NEW tokens
        one = gen(model, draft, SPEC_NEW, SPEC_SEED, None)
        n_again = SPEC_NEW if variant == "lookup" else SPEC_EAGER_NEW
        again = gen(model, draft, n_again, SPEC_SEED, None)
        once = one if n_again == SPEC_NEW else gen(model, draft, n_again, SPEC_SEED, None)
        other = gen(model, draft, SPEC_PLAIN_NEW, SPEC_SEED + 1, None)
        pk = gen(model, draft, SPEC_PLAIN_NEW, SPEC_SEED, False)
        pp = gen(plain, draft_plain, SPEC_PLAIN_NEW, SPEC_SEED, False)
        pg = gen(model, draft, SPEC_PLAIN_NEW, SPEC_SEED, None)
        row = dict(variant=variant, sampler=SPEC_SAMPLER, seed=SPEC_SEED,
                   seed_repeats=once[:3] == again[:3], repeat_tokens=n_again,
                   other_seed_differs=one[0][:SPEC_PLAIN_NEW] != other[0],
                   kernel_equals_plain=pk[:3] == pp[:3],
                   graph_equals_eager_short=pg[:3] == pk[:3],
                   tokens_per_forward=(SPEC_NEW - 1) / max(one[1], 1), forwards=one[1],
                   draft_forwards=one[2], bursts=one[3]["bursts"],
                   host_syncs=one[3]["host_syncs"], replays=one[3]["replays"],
                   tokens_per_s_with_prefill=SPEC_NEW / one[4],
                   in_range=all(0 <= t < cfg.vocab_size for t in one[0]),
                   tokens_head=one[0][:12], at_s=round(time.perf_counter() - t_phase, 1))
        say("spec_sampled", **row)
        if not (row["seed_repeats"] and row["kernel_equals_plain"] and row["in_range"]
                and one[3]["graph"] and one[3]["replays"]):
            raise AssertionError(f"spec sampled {variant}: {row}")

    # the engine's speculative mode against the same engine without it
    ptoks = [prompts["periodic"][0].tolist(), prompts["random"][0].tolist()]
    outs, stats = {}, {}
    for spec in (False, True):
        eng = InferenceEngine(model, speculative=spec, **SPEC_ENGINE)
        uids = [eng.submit(p, max_new_tokens=SPEC_ENGINE_NEW) for p in ptoks]
        uids.append(eng.submit(ptoks[0], max_new_tokens=SPEC_ENGINE_SAMPLED_NEW,
                               seed=SPEC_SEED, **SPEC_SAMPLER))
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        outs[spec] = [eng.finished[u].output for u in uids]
        stats[spec] = dict({k_: v for k_, v in eng.stats.items()
                            if k_ in ("chunks", "decode_tokens", "spec_forwards",
                                      "graph_captures", "graph_replays", "eager_steps",
                                      "decode_s")},
                           wall_s=time.perf_counter() - t0)
    eng_rows = []
    for i, p in enumerate(ptoks):
        div = spec_divergence(model, np.asarray([p]), SPEC_ENGINE["max_len"], outs[False][i],
                              outs[True][i], SPEC_K)
        eng_rows.append(dict(prompt=list(prompts)[i], tokens=len(outs[True][i]), **div))
        agree_all += div["first_divergence"] is None
    sampled_same = outs[True][2] == outs[False][2]
    say("spec_engine", streams=eng_rows, sampled_equal_plain_engine=sampled_same,
        stats=stats, at_s=round(time.perf_counter() - t_phase, 1), card=card.name,
        nvidia_smi=card.smi)
    if not (sampled_same and stats[True].get("spec_forwards", 0) > 0
            and len(outs[True][2]) == SPEC_ENGINE_SAMPLED_NEW):
        raise AssertionError(f"spec engine: {stats}")

    # where a verification forward's time goes, against a one-token step
    split, k1_9 = verify_split(card, cfg, params, model, clone_cache(snaps["periodic"]),
                               SPEC_K)
    split5, k1_5 = verify_split(card, cfg, params, model, clone_cache(snaps["periodic"]),
                                SPEC_DRAFT_K)
    say("spec_verify_split", k8=split, k4=split5, at_s=round(time.perf_counter() - t_phase, 1),
        card=card.name, nvidia_smi=card.smi)

    # the kernels' records: K1 at 9 and 5 rows per verification forward
    # (the linears' calls times the layers and the head), K2 at the draft's
    # head per draft step
    records = []
    for N, label, (rows, tot, head) in ((SPEC_K + 1, "K1 N=9", k1_9),
                                        (SPEC_DRAFT_K + 1, "K1 N=5", k1_5)):
        hb = card.bound_ms(qgemm_bytes(params["lm_head"], card.bf16(N, cfg.hidden_size), {}),
                           2 * N * params["lm_head"].kdim_padded
                           * params["lm_head"].mdim_padded, card.int8_peak)
        say("spec_k1_times", N=N, rows=rows, head_ms=head[0], head_plain_ms=head[1],
            head_library_ms=head[3])
        records.append(dict(
            name=f"qgemm_fused (K1) N={N}", path="bitnet-3b speculative", route="cuda",
            source="tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu",
            replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:567",
            launches=launched[label], max_abs_err=k1_err, ms=tot["ms"] + head[0],
            plain_ms=tot["plain_ms"] + head[1], bound_ms=tot["bound_ms"] + hb,
            bound_by=dominant_bound(rows), library_ms=tot["library_ms"] + head[3]))
    zero_counts()
    _, dcache = spec_prefill(draft, prompts["random"], S)
    k2 = time_k2(card, cfg_d, dcache, SPEC_PROMPT + SPEC_NEW // 2)
    records.append(dict(
        name="flash_decode (K2) head_dim 96", path="bitnet-700m draft", route="cuda",
        source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
        replaces="tmac_tpu/ops/pallas/attention_kernel.py:367",
        launches=launched["K2 draft"], max_abs_err=k2_err, ms=k2[0] * Ld,
        plain_ms=k2[1] * Ld, bound_ms=k2[2] * Ld, bound_by="bytes", library_ms=k2[3] * Ld))
    say("spec_summary", streams=len(streams) + len(eng_rows), agree_throughout=agree_all,
        launches=launched, seconds=round(time.perf_counter() - t_phase, 3),
        card=card.name, nvidia_smi=card.smi)
    del model, plain, draft, draft_plain, params, params_d
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# path 11: GGUF on the card -- Llama-3.1-8B exported to Q4_K and read back
# (f32 grouped scales in K4, K4L and K5), and a 2-layer Mixtral-8x7B (K7)
# ---------------------------------------------------------------------------

# Llama-3.1-8B Q4_K: 600 tokens in chunks of 512 (one 512-row chunk on K5,
# one of 88 rows on K4L, whose down at K 14336 is past K4L's old limit);
# Mixtral-8x7B Q4_K at 2 of its 32 layers (the only cut): a 64-token
# prompt and 16 teacher-forced decode steps
GGUF_PROMPT, GGUF_CHUNK = 600, 512
GGUF_MOE_LAYERS, GGUF_MOE_PROMPT, GGUF_MOE_FORCED = 2, 64, 16
# path 11's depth since the full run took paths 13, 14 and 14b: 16 of
# Llama-3.1-8B's 32 layers (at 32 the path took ~56 s more, PERF.md §4)
GGUF_LAYERS = 16


def gguf_roundtrip(card, cfg, tag, wtype="Q4_K", form=(4, 32)):
    """cfg's weights drawn on the card (params_on_card, seed 0), written by
    export_gguf as `wtype` to a temporary directory, read back by
    convert_gguf_model on the card; the file deleted.  form: the (bits,
    group size) its matmul weights must read back as (Q4_K (4, 32), Q2_K
    (2, 16), Q8_0 (8, 32): the config of a Q8_0 file says bits 4, so the
    weights' own form is checked), with f32 scales.  Prints the seconds of
    the draw, the export, the read (the header, the directory and every
    tensor's bytes through the reader's map; the file warm in the page
    cache) and the conversion.  -> (the gguf's config, its params on the
    card)"""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from tmac_tpu_torch.convert import gguf as gg
    from tmac_tpu_torch.convert.gguf import GGUFReader, convert_gguf_model
    from tmac_tpu_torch.convert.gguf_export import dequant_float, export_gguf
    t0 = time.perf_counter()
    params = params_on_card(cfg, 0, card.dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    # the writer packs Q2_K, Q4_K and Q8_0 on the tensor's device: the
    # card's bytes are the CPU's (which the CPU tests hold to the JAX
    # package's), on layer 0's wo dequantized
    w = dequant_float(params["layers"][0]["wo"]).t().contiguous()
    same_bytes = {name: gg._tensor_data(t, w) == gg._tensor_data(t, w.cpu())
                  for name, t in (("q2_k", gg.GGML_Q2_K), ("q4_k", gg.GGML_Q4_K),
                                  ("q8_0", gg.GGML_Q8_0))}
    del w
    d = tempfile.mkdtemp(prefix="gguf_")
    try:
        path = f"{d}/{tag}.gguf"
        free_gb = shutil.disk_usage(d).free / 1e9
        t0 = time.perf_counter()
        info = export_gguf(path, cfg, params, wtype=wtype)
        export_s = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        r = GGUFReader(path)
        touched = sum(int(np.bitwise_xor.reduce(r.tensor_bytes(n)[::4096]))
                      for n in r.tensors)
        types = sorted({gg._TYPE_NAMES[t["type"]] for t in r.tensors.values()})
        r.close()
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gcfg, gparams = convert_gguf_model(path, name=f"{cfg.name}-{wtype.lower()}",
                                           device=card.dev)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        # a tensor of the file's type converts on the card to the CPU's
        # bytes
        r = GGUFReader(path)
        name = "blk.0.attn_output.weight"
        on_card = gg._qt_from_gguf(r, name, 1, 1, device=card.dev)
        host = gg._qt_from_gguf(r, name, 1, 1, device="cpu").to(card.dev)
        r.close()
        same_bytes[f"{wtype.lower()}_convert"] = all(
            torch.equal(getattr(on_card, f), getattr(host, f))
            for f in ("packed", "scales", "sub"))
        del on_card, host
    finally:
        shutil.rmtree(d, ignore_errors=True)
    l0 = gparams["layers"][0]
    qts = [l0[n] for n in ("wqkv", "wo", "gate_up", "down") if n in l0] + [
        l0[n] for n in ("experts_gate_up", "experts_down") if n in l0]
    same = dict(hidden=gcfg.hidden_size == cfg.hidden_size,
                layers=gcfg.num_layers == cfg.num_layers,
                heads=(gcfg.num_heads, gcfg.num_kv_heads) == (cfg.num_heads, cfg.num_kv_heads),
                vocab=gcfg.vocab_size == cfg.vocab_size,
                experts=gcfg.num_experts == cfg.num_experts,
                rope=(cfg.rope_scaling is None) == (gcfg.rope_scaling is None),
                form=all((q.bits, q.group_size) == form for q in qts),
                f32_scales=all(q.scales.dtype == torch.float32 for q in qts),
                int8_head=gparams["lm_head"].bits == 8, **same_bytes)
    say(f"{tag}_gguf", model=cfg.name, wtype=wtype, bytes=info["bytes"],
        tensors=info["tensors"], types=types, free_gb_before=round(free_gb, 1),
        draw_s=round(draw_s, 3), export_s=round(export_s, 3), read_s=round(read_s, 3),
        convert_s=round(convert_s, 3), read_checksum=touched,
        rope_scaling=gcfg.rope_scaling[0] if gcfg.rope_scaling else None, checks=same,
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    if not all(same.values()):
        raise AssertionError(f"{tag}: the gguf's model is not the one written: {same}")
    return gcfg, gparams


def gguf_path(card, layers=GGUF_LAYERS):
    """Path 11: Llama-3.1-8B (at `layers` of its 32 layers) and
    Mixtral-8x7B through a gguf file (module docstring, phase 17).  -> the
    kernels' records"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    t_path = time.perf_counter()
    cfg0 = dataclasses.replace(get_preset("llama-3.1-8b", bits=4, group_size=32,
                                          zero_point=True), num_layers=layers)
    cfg, params = gguf_roundtrip(card, cfg0, "gguf_llama31")
    # K4L at K 14336, gs 32 with bf16 scales too (past the shared memory
    # that staged every group's factors): down with and without its fold
    down = params["layers"][0]["down"]
    down_bf16 = dataclasses.replace(down, scales=down.scales.to(torch.bfloat16),
                                    sub=down.sub.to(torch.bfloat16))
    I = down.kdim
    bf16_rows, _ = check_k4(card, [
        (f"down {dt}", card.bf16(N, 2 * I if glu else I), q,
         dict(glu=True, residual=card.bf16(N, down.mdim)) if glu else {})
        for N in (64, 88) for glu in (False, True)
        for dt, q in (("bf16", down_bf16), ("f32", down))])
    say("gguf_k4l_k14336", rows=bf16_rows)
    del down_bf16
    records = grouped_path(card, "gguf_llama31", cfg, GGUF_PROMPT, GGUF_CHUNK,
                           params=params, k4_rows=(1, 4, 16, 64, 88), k5_rows=(512,))
    del params
    torch.cuda.empty_cache()
    records += gguf_mixtral(card)
    say("gguf_path", path_s=round(time.perf_counter() - t_path, 3), layers=layers,
        card=card.name, nvidia_smi=card.smi)
    return records


def gguf_mixtral(card, wtype="Q4_K", form=(4, 32), forced=GGUF_MOE_FORCED):
    """Mixtral-8x7B at full width, 2 of its 32 layers, through a gguf file
    of `wtype` (Q4_K; Q2_K for K7 at gs 16) whose matmul weights read back
    as `form` (bits, group size): K7's form against its plain version (N =
    1 and 4, gate_up and down, every cluster size); a 64-token prompt (the
    experts' capacity dispatch at 32 slots on K4, wqkv and wo on K4L, or
    at gs 16 on K5, the head on K3) and 64 greedy steps through
    decode_loop (4 K7, 4 K4, 2 K2, 1 K1 a step: the experts on K7, none
    through apply_qlinear), teacher-forced on the prompt and `forced`
    steps (where the prompt takes K5, whose tensor cores
    sum in their own order, on its last position within LLAMA_TF_NMSE and
    the steps from the kernel path's cache, as grouped_path does); K7 per
    step.  -> its record"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.moe import expert_capacity, expert_view
    from tmac_tpu_torch.ops.qgemm import route
    t_path = time.perf_counter()
    bits, gs = form
    tag = "gguf_mixtral" if wtype == "Q4_K" else f"gguf_{wtype.lower()}_mixtral"
    cfg0 = dataclasses.replace(get_preset("mixtral-8x7b", bits=min(bits, 4), group_size=gs,
                                          zero_point=True), num_layers=GGUF_MOE_LAYERS)
    cfg, params = gguf_roundtrip(card, cfg0, tag, wtype, form)
    layers, L, E, H = params["layers"], cfg.num_layers, cfg.num_experts, cfg.hidden_size
    gu0, dn0 = layers[0]["experts_gate_up"], layers[0]["experts_down"]
    Ie = dn0.kdim
    cases = []
    for N in (1, 4):
        cases += [("gate_up", card.bf16(1, N, H), gu0, False),
                  ("down", card.bf16(E, N, 2 * Ie).float(), dn0, True)]
    k7_rows, k7_err = check_k7(card, cases, splits=(1, 2, 4, 8))
    say(f"{tag}_k7_check", at_s=round(time.perf_counter() - t_path, 3), checks=k7_rows)
    # the prompt's kernels: wqkv and wo at its rows, the experts at their
    # capacity (each expert's two linears), as ops.qgemm.route picks them
    C = expert_capacity(GGUF_MOE_PROMPT, cfg)
    attn = route(layers[0]["wqkv"], GGUF_MOE_PROMPT)
    experts = route(expert_view(gu0, 0), C)
    want = {"K3": 1, attn: 2 * L}
    want[experts] = want.get(experts, 0) + 2 * E * L
    k5 = "K5" in want
    main = run_path(card, tag, cfg, params, GGUF_MOE_PROMPT, counts(**want),
                    counts(K1=1.0, K4=2.0 * L, K2=float(L), K7=2.0 * L),
                    forced=forced, tf_gate=LLAMA_TF_NMSE if k5 else None,
                    tf_last_only=k5)
    k7_times, tot = time_k7_step(card, cfg, layers)
    say(f"{tag}_k7_times", rows=k7_times, per_step=dict(tot, calls=2 * L),
        capacity=C, prompt_kernels=want,
        step=dict(eager_ms=main["step_ms"], graph_ms=main["graph_step_ms"],
                  decode_loop_ms=main["loop_ms"]),
        path_s=round(time.perf_counter() - t_path, 3), card=card.name, nvidia_smi=card.smi)
    gform = f" gs {gs}" if gs == 16 else ""
    return [dict(name=f"qgemm_experts (K7) bits {bits} f32 scales{gform}", path=cfg.name,
                 route="cuda", source="tmac_tpu_torch/ops/cuda/csrc/qgemm_expert.cu",
                 replaces="tmac_tpu/ops/pallas/expert_kernel.py:207",
                 launches=main["launches"]["K7"], max_abs_err=k7_err,
                 ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                 bound_by="bytes", library_ms=tot["library_ms"])]


# ---------------------------------------------------------------------------
# per_channel_path: w_fp with one f32 scale and zero point a column
# (group_size -1), K1 and K3 at bits 1, 3 and 4, on Llama-3.1-8B W4A8
# ---------------------------------------------------------------------------

# path 12's prompt in chunks (K3 on every linear and the head); the form
# checks' bits and rows (K1 below 64, K3 from 64), the seed of their weights
PC_PROMPT, PC_CHUNK = 1024, 512
PC_BITS, PC_K1_ROWS, PC_K3_ROWS, PC_FORM_SEED = (1, 3, 4), (1, 4, 16), (64, 256, 1024), 17


def pc_shapes(cfg):
    """Path 12's four linear shapes: (name, K, M) of wqkv, wo, gate_up and
    down."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    return (("wqkv", H, cfg.q_dim + 2 * cfg.kv_dim), ("wo", cfg.q_dim, H),
            ("gate_up", H, 2 * I), ("down", I, H))


def pc_form_checks(card, cfg):
    """K1 and K3 at bits 1, 3 and 4 on path 12's four linear shapes, weights
    drawn on the card with per-column f32 scales and zero points
    (pt_qt_on_card): K1 at N = 1, 4 and 16 through the wrapper (decode_plan's
    cluster size) and at every cluster size of DECODE_SPLITS a block's
    shared memory takes; K3 at N = 64, 256 and 1024 through the wrapper
    and at every tile and cluster size large_plan may take
    (check_k3_tiles); each bit for bit against its plain version, with the
    prologue's codes, scales and code sums and the int32 sums byte for
    byte.  Each form timed on each shape: K1 at N = 1 and K3 at N =
    PC_CHUNK (time_k4, time_k3: CUDA graphs of the calls over `copies`
    weights of the shape, as many as make 120 MB, at most 8, so most do not
    stay in the 50 MB L2) beside the bound, the plain version and the
    yardsticks.  -> (rows by bits, worst error of K1, of K3)"""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(PC_FORM_SEED)
    out, worst = {}, [0.0, 0.0]
    for bits in PC_BITS:
        t0 = time.perf_counter()
        k1_rows, k3_rows, times = [], [], []
        for sh, K, M in pc_shapes(cfg):
            n = max(1, min(8, math.ceil(120e6 / (K * M * bits / 8))))
            qts = [pt_qt_on_card(gen, K, M, bits, card.dev) for _ in range(n)]
            qt = qts[0]
            rows, err = check_k1(card, [(sh, card.bf16(N, K), qt, {}) for N in PC_K1_ROWS],
                                 splits=(None,) + k1.DECODE_SPLITS)
            worst[0] = max(worst[0], err)
            k1_rows.append(dict(shape=sh, K=K, M=M, checks=len(rows),
                                refused=[(r["N"], r["ksplit"]) for r in rows if "refused" in r],
                                bitwise=all(r.get("bitwise", True) for r in rows),
                                plans={N: k1.decode_plan(N, K, M, bits, 0, card.sms)
                                       for N in PC_K1_ROWS}))
            for N in PC_K3_ROWS:
                x = card.bf16(N, K)
                rows, err = check_k3(card, [(sh, x, qt, {})], splits=(None,))
                tiles, err2 = check_k3_tiles(card, sh, x, qt, {})
                worst[1] = max(worst[1], err, err2)
                k3_rows.append(dict(shape=sh, N=N, plan=rows[0]["plan"],
                                    configs=len(tiles["configs"]),
                                    bitwise=rows[0]["bitwise"]["None"] and all(
                                        c["bitwise"] for c in tiles["configs"]),
                                    codes_acc_equal=rows[0]["codes_equal"]
                                    and rows[0]["acc_equal"]))
            times.append(dict(shape=sh, K=K, M=M, copies=n,
                              k1=time_k4(card, [(card.bf16(1, K), q, {}) for q in qts]),
                              k3=time_k3(card, [(card.bf16(PC_CHUNK, K), q, {})
                                                for q in qts])))
            del qts, qt
            torch.cuda.empty_cache()
        out[bits] = dict(k1=k1_rows, k3=k3_rows, times=times)
        say(f"pc_forms_bits{bits}", bits=bits, k1=k1_rows, k3=k3_rows, times=times,
            seconds=round(time.perf_counter() - t0, 3), card=card.name, nvidia_smi=card.smi)
    return out, worst[0], worst[1]


def per_channel_path(card):
    """Path 12: Llama-3.1-8B (32 layers, hidden 4096, 32 heads over 8 KV
    heads, FFN 14336, vocab 128256, llama3 rope scaling) at w_fp bits 4,
    group_size -1 with zero points (W4A8 per channel: one f32 scale and
    zero point a column, the activations int8 per token), weights drawn on
    the card (seed 0): first the form checks of K1 and K3 at bits 1, 3 and
    4 (pc_form_checks); K1 (N = 1, 4) and K3 (N = PC_CHUNK) on layer 0's
    four linears with their folds and on the int8 head, K2 at rep 4, each
    against its plain version; then run_path's main run, a 1024-token
    prompt in chunks of 512 (K3 on the four linears of every layer and the
    head a chunk: 258) and 64 steps through decode_loop (129 K1 and 32 K2 a
    step), teacher-forced on every position and 8 steps against the plain
    versions at PATH_NMSE (K1 and K3 sum integers exactly, so no noise
    gate); K1's time per step and K3's per prefill beside their bounds,
    plain versions and yardsticks.  -> the kernels' records"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    t_path = time.perf_counter()
    cfg = get_preset("llama-3.1-8b", bits=4).with_quant(group_size=-1, zero_point=True)
    forms, form_k1_err, form_k3_err = pc_form_checks(card, cfg)
    t_params = time.perf_counter()
    params = params_on_card(cfg, 0, card.dev)
    torch.cuda.synchronize()
    layers, L, H = params["layers"], cfg.num_layers, cfg.hidden_size
    rep, l0, head = cfg.num_heads // cfg.num_kv_heads, layers[0], params["lm_head"]
    say("llama31_pc_build", model=cfg.name, bits=cfg.quant.bits, group_size=-1,
        zero_point=True, layers=L, forms_s=round(t_params - t_path, 3),
        init_params_s=round(time.perf_counter() - t_params, 3),
        scales=str(l0["wqkv"].scales.dtype), scale_rows=l0["wqkv"].scales.shape[0],
        linear_weight_gb=round(L * sum(l0[n].packed.numel() for n in LINEARS) / 1e9, 3),
        allocated_gb=round(torch.cuda.memory_allocated() / 1e9, 3))
    k1_rows, k1_err = check_k1(card, [(sh, *linear_call(card, cfg, sh, N, l0))
                                      for sh in LINEARS for N in (1, 4)]
                               + [("head", card.bf16(1, H), head, {})])
    k3_rows, k3_err = check_k3(card, [(sh, *linear_call(card, cfg, sh, PC_CHUNK, l0))
                                      for sh in LINEARS]
                               + [("head", card.bf16(PC_CHUNK, H), head, {})])
    k2_rows, k2_err = check_k2_heads(card, cfg.num_kv_heads, rep, cfg.head_dim)
    say("llama31_pc_checks", at_s=round(time.perf_counter() - t_path, 3), k1=k1_rows,
        k3=k3_rows, k2=k2_rows)

    # the prefill: K3 on the 4 linears of every layer and on the head, a
    # chunk; a step: K1 on the 4 linears of every layer and the head, K2 a layer
    chunks = PC_PROMPT // PC_CHUNK
    main = run_path(card, "llama31_pc", cfg, params, PC_PROMPT,
                    counts(K3=(4 * L + 1) * chunks), counts(K1=4.0 * L + 1, K2=float(L)),
                    chunk=PC_CHUNK)
    launches = main["launches"]
    k1_times, k1_tot = per_linear_times(card, cfg, layers, 1, time_k4, L)
    h_ms, h_plain, h_bound, h_lib = time_head(card, head)
    for key, val in (("ms", h_ms), ("plain_ms", h_plain), ("bound_ms", h_bound),
                     ("library_ms", h_lib)):
        k1_tot[key] += val
    say("llama31_pc_k1_times", rows=k1_times,
        head=dict(ms=h_ms, plain_ms=h_plain, bound_ms=h_bound, library_ms=h_lib),
        per_step=dict(k1_tot, calls=4 * L + 1), card=card.name, nvidia_smi=card.smi)
    k3_times, k3_tot = per_linear_times(card, cfg, layers, PC_CHUNK, time_k3, L * chunks)
    k3_head = time_k3(card, [(card.bf16(PC_CHUNK, H), head, {})])
    k3_times.append(dict(shape="head", per=chunks, **k3_head))
    for key in k3_tot:
        k3_tot[key] += chunks * k3_head[key]
    say("llama31_pc_k3_times", rows=k3_times,
        per_prefill=dict(k3_tot, calls=(4 * L + 1) * chunks), card=card.name,
        nvidia_smi=card.smi)
    kv_len = PC_PROMPT + (1 + STEPS) // 2
    k2_ms, k2_plain, k2_bound, k2_lib = time_k2(card, cfg, main["cache"], kv_len)
    say("llama31_pc_step", eager_ms=main["step_ms"], graph_ms=main["graph_step_ms"],
        decode_loop_ms=main["loop_ms"],
        kernel_bound_ms=k1_tot["bound_ms"] + k2_bound * L, kv_len=kv_len, k2_ms=k2_ms,
        k2_plain_ms=k2_plain, k2_bound_ms=k2_bound, k2_library_ms=k2_lib,
        prefill_k3_ms=k3_tot["ms"], prefill_k3_bound_ms=k3_tot["bound_ms"],
        card=card.name, nvidia_smi=card.smi, path_s=round(time.perf_counter() - t_path, 3))
    src = "tmac_tpu_torch/ops/cuda/csrc/"

    def rec(name, source, replaces, label, err, t, by):
        return dict(name=name, path="llama-3.1-8b-w4a8-per-channel", route="cuda",
                    source=src + source, replaces="tmac_tpu/ops/pallas/" + replaces,
                    launches=launches[label], max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=by,
                    library_ms=t["library_ms"])
    records = [
        rec("qgemm_fused (K1) per-channel bits 4", "qgemm_fused.cu", "qgemm_kernel.py:567",
            "K1", max(k1_err, form_k1_err), k1_tot, "bytes"),
        rec("qgemm_large_int (K3) per-channel bits 4", "qgemm_large.cu",
            "qgemm_kernel.py:266", "K3", max(k3_err, form_k3_err), k3_tot,
            dominant_bound(k3_times)),
        rec("flash_decode (K2) rep 4", "flash_decode.cu", "attention_kernel.py:367", "K2",
            k2_err, dict(ms=k2_ms * L, plain_ms=k2_plain * L, bound_ms=k2_bound * L,
                         library_ms=k2_lib * L), "bytes"),
    ]
    del params, main, layers, head, forms
    return records


# ---------------------------------------------------------------------------
# gguf_lowbit_path: GGUF's Q2_K and Q8_0 on the card, group size 16 and
# grouped bits 8 in K4, K4L and K5, K4 and K4L at ags 16, K7 at gs 16
# ---------------------------------------------------------------------------

# path 14's depth (16 of 32 layers; the full run's is LB_FULL_RUN_Q8_LAYERS, PERF.md §4);
# paths 13 and 14b's teacher-forced steps in the full run (their plain K4
# and K7 fold 896 groups an output at gs 16, in a Python loop: 29 and 3.5 s
# a step on a slow host, PERF.md §4), where --phase gguf_lowbit_path
# forces NEW_FORCED and GGUF_MOE_FORCED; the form checks' (bits, group
# size, scale dtype) on Llama-3.1-8B's shapes (gs 16 at bits 1-4: Q2_K's and Q3_K's forms; bits 8
# at gs 32, Q8_0's, and 16), their rows, ags and seed; path 7's config for
# the ags-16 checks
LB_Q8_LAYERS = 16
LB_FULL_RUN_FORCED = (1, 1)
# the full run's cuts since it took tools_path, then lut_forms and path 15,
# then attn_forms and paths 16-17 (PERF.md §4): path 13 at 2 of 32 layers,
# path 14 at 2 (of LB_Q8_LAYERS), path 11 at 2 of 32
LB_FULL_RUN_Q2K_LAYERS, LB_FULL_RUN_Q8_LAYERS, GGUF_FULL_RUN_LAYERS = 2, 2, 2
LB_FORMS = tuple((b, 16, dt) for b in (2, 3, 1, 4) for dt in ("f32", "bf16")) + (
    (8, 32, "f32"), (8, 32, "bf16"), (8, 16, "f32"))
LB_K4_ROWS, LB_K4L_ROWS, LB_K5_ROWS, LB_AGS, LB_FORM_SEED = (1, 4, 16), (64, 88), (512,), 16, 18


def lowbit_form_checks(card, cfg):
    """K4 (N = 1, 4, 16 through the wrapper and at every cluster size of
    DECODE_SPLITS a block's shared memory takes), K4L (dispatch "chunk",
    N = 64, 88) and K5 (N = 512) on Llama-3.1-8B's four linear shapes
    (pc_shapes) at each form of LB_FORMS, weights drawn on the card
    (rand_qt_on_card, seed LB_FORM_SEED): each bit for bit against its
    plain version, with the prologue's codes, scales and code sums byte
    for byte (K5 within k5_bound, its activations and dequantized weights
    byte for byte); then K4 (N = 1, 4, 16, with the model's folds: within
    FOLDED_NMSE, and without: bit for bit) and K4L (N = 64, 88, with and
    without folds, bit for bit) at ags 16 on a layer of path 7's config
    (Llama-2-7B W2 g128, drawn as params_on_card draws it).  Timed, each
    over one layer's four linears (time_k4: CUDA graphs of the calls):
    K4L at gs 16 on Q2_K's form (bits 2, f32) at 88 rows, K4 at ags 16 at
    1 row and K4L at ags 16 at 256, beside their bounds, plain versions and
    yardsticks.  -> (records of the three timed forms, the worst errors of
    K4, K4L and K5 over every form)"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(LB_FORM_SEED)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst = dict(K4=0.0, K4L=0.0, K5=0.0)
    timed = {}
    for bits, gs, dt in LB_FORMS:
        t0 = time.perf_counter()
        zero_counts()
        rows, times = [], []
        for sh, K, M in pc_shapes(cfg):
            qt = rand_qt_on_card(gen, K, M, bits, gs, card.dev, dtypes[dt])
            k4_rows, _ = check_k4(card, [(sh, card.bf16(N, K), qt, {})
                                         for N in LB_K4_ROWS + LB_K4L_ROWS],
                                  splits=(None,) + k1.DECODE_SPLITS)
            k5_rows, k5_err = check_k5(card, [(sh, card.bf16(N, K), qt, {})
                                              for N in LB_K5_ROWS])
            for r in k4_rows:
                worst[r["kernel"]] = max(worst[r["kernel"]], r.get("max_abs_err", 0.0))
            worst["K5"] = max(worst["K5"], k5_err)
            ok = [r for r in k4_rows if "refused" not in r]
            rows.append(dict(shape=sh, K=K, M=M, k4=sum(r["kernel"] == "K4" for r in ok),
                             k4l=sum(r["kernel"] == "K4L" for r in ok),
                             refused=[(r["N"], r["ksplit"]) for r in k4_rows
                                      if "refused" in r],
                             bitwise=all(r["bitwise"] for r in ok),
                             k5_within_bound=all(r["within_bound"] for r in k5_rows),
                             k5_max_ratio=max(r["max_ratio"] for r in k5_rows),
                             plans={N: k1.decode_plan(N, K, M, bits, gs, card.sms,
                                                      scale_bytes=qt.scales.element_size())
                                    for N in LB_K4_ROWS}))
            if (bits, gs, dt) == (2, 16, "f32"):
                times.append(dict(shape=sh, **time_k4(card, [(card.bf16(88, K), qt, {})],
                                                      reps=5)))
            del qt
        launches = read_counts()
        if times:
            timed["K4L gs 16"] = (times, launches["K4L"])
        torch.cuda.empty_cache()
        say(f"lowbit_forms_b{bits}_g{gs}_{dt}", bits=bits, group_size=gs, scales=dt,
            rows=rows, k4l_times=times, launches=launches,
            seconds=round(time.perf_counter() - t0, 3), card=card.name, nvidia_smi=card.smi)
    # ags 16 on a layer of path 7's config, with and without its folds
    t0 = time.perf_counter()
    cfg7 = dataclasses.replace(get_preset("llama-2-7b").with_quant(act_group_size=LB_AGS),
                               num_layers=1)
    l0 = params_on_card(cfg7, 0, card.dev)["layers"][0]
    zero_counts()
    cases = [(sh, *linear_call(card, cfg7, sh, N, l0, folds)) for sh in LINEARS
             for N in LB_K4_ROWS + LB_K4L_ROWS for folds in (True, False)]
    ags_rows, _ = check_k4(card, cases)
    for r in ags_rows:
        worst[r["kernel"]] = max(worst[r["kernel"]], r.get("max_abs_err", 0.0))
    k4_times = [dict(shape=sh, **time_k4(card, [linear_call(card, cfg7, sh, 1, l0)]))
                for sh in LINEARS]
    k4l_times = [dict(shape=sh, **time_k4(card, [linear_call(card, cfg7, sh, 256, l0)],
                                          reps=5)) for sh in LINEARS]
    launches = read_counts()
    timed["K4 ags 16"] = (k4_times, launches["K4"])
    timed["K4L ags 16"] = (k4l_times, launches["K4L"])
    ran = [r for r in ags_rows if "refused" not in r]
    say("lowbit_forms_ags16", model=cfg7.name, act_group_size=LB_AGS,
        checks=len(ran), refused=[(r["shape"], r["N"], r["ksplit"]) for r in ags_rows
                                  if "refused" in r],
        bitwise_unfolded=all(r["bitwise"] for r in ran if not r["folds"]),
        worst_folded_nmse=max(r["nmse"] for r in ran if r["folds"]),
        k4_times=k4_times, k4l_times=k4l_times, launches=launches,
        seconds=round(time.perf_counter() - t0, 3), card=card.name, nvidia_smi=card.smi)
    del l0
    torch.cuda.empty_cache()
    src = "tmac_tpu_torch/ops/cuda/csrc/"
    records = []
    for name, source, label, path in (
            ("qgemm_grouped_large (K4L) bits 2 f32 scales gs 16", "qgemm_grouped_large.cu",
             "K4L gs 16", "llama-3.1-8b shapes, 88 rows, dispatch chunk (checks)"),
            ("qgemm_grouped (K4) bits 2 ags 16", "qgemm_grouped.cu", "K4 ags 16",
             "llama-2-7b-ags16 layer, 1 row (checks)"),
            ("qgemm_grouped_large (K4L) bits 2 ags 16", "qgemm_grouped_large.cu",
             "K4L ags 16", "llama-2-7b-ags16 layer, 256 rows (checks)")):
        rows, launches = timed[label]
        tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms",
                                                    "library_ms")}
        records.append(dict(name=name, path=path, route="cuda", source=src + source,
                            replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:" + (
                                "567" if label.startswith("K4 ") else "428"),
                            launches=launches, max_abs_err=worst[label.split()[0]],
                            bound_by=dominant_bound(rows), **tot))
    return records, worst


def gguf_lowbit_path(card, forced=(NEW_FORCED, GGUF_MOE_FORCED), q2k_layers=None,
                     q8_layers=LB_Q8_LAYERS):
    """The low-bit GGUF forms (module docstring, phase 19): the form
    checks (lowbit_form_checks), then path 13, Llama-3.1-8B at full width
    and depth through a Q2_K gguf file (bits 2, gs 16, f32 scales: a
    600-token prompt in chunks of 512 and 88, both on K5 at gs 16, 64 steps
    on K4 at gs 16), path 14, Llama-3.1-8B through a Q8_0 file (bits 8, gs
    32: the 512-row chunk on K5, the 88-row one on K4L, the steps on K4, at
    q8_layers layers), each as path 11 runs (gguf_roundtrip, then
    grouped_path on the file's weights), and path 14b, Mixtral-8x7B at 2
    of 32 layers through a Q2_K file (K7 at gs 16).  forced: the decode
    steps teacher-forced on paths 13 and 14b; q2k_layers: path 13's depth
    (all 32 by default); q8_layers: path 14's.  -> the kernels' records"""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    t_path = time.perf_counter()
    cfg = get_preset("llama-3.1-8b", bits=2, group_size=16, zero_point=True)
    records, _ = lowbit_form_checks(card, cfg)
    t_forms = time.perf_counter() - t_path
    gcfg, params = gguf_roundtrip(card, dataclasses.replace(
        cfg, num_layers=q2k_layers or cfg.num_layers), "gguf_q2k", "Q2_K", (2, 16))
    records += grouped_path(card, "gguf_q2k", gcfg, GGUF_PROMPT, GGUF_CHUNK, params=params,
                            k4_rows=(1, 4, 16, 64, 88), k5_rows=(512,), forced=forced[0])
    del params
    torch.cuda.empty_cache()
    t_q8 = time.perf_counter()
    cfg8 = dataclasses.replace(get_preset("llama-3.1-8b", bits=4, group_size=32,
                                          zero_point=True), num_layers=q8_layers)
    gcfg, params = gguf_roundtrip(card, cfg8, "gguf_q8", "Q8_0", (8, 32))
    records += grouped_path(card, "gguf_q8", gcfg, GGUF_PROMPT, GGUF_CHUNK, params=params,
                            k4_rows=(1, 4, 16, 64, 88), k5_rows=(512,))
    del params
    torch.cuda.empty_cache()
    t_moe = time.perf_counter()
    records += gguf_mixtral(card, "Q2_K", (2, 16), forced[1])
    torch.cuda.empty_cache()
    say("gguf_lowbit_path", forms_s=round(t_forms, 3), q2k_s=round(t_q8 - t_path - t_forms, 3),
        q8_s=round(t_moe - t_q8, 3), moe_s=round(time.perf_counter() - t_moe, 3),
        path_s=round(time.perf_counter() - t_path, 3), q8_layers=q8_layers, forced=forced,
        q2k_layers=q2k_layers or cfg.num_layers, forms=len(LB_FORMS),
        card=card.name, nvidia_smi=card.smi)
    return records


# ---------------------------------------------------------------------------
# tools_path: qgemm_pallas's forms whose activations come from outside (E1-E4)
# at full width, then the port's tools and CLI, in-process
# ---------------------------------------------------------------------------

# the linears (K, M) of Llama-2-7B (bits 2 and 4, g128) and BitNet-3B (w_a8)
TOOLS_LLAMA = ((4096, 4096), (4096, 11008), (11008, 4096))
TOOLS_BITNET = ((3200, 3200), (3200, 8704), (8704, 3200))
FORM_ROWS = {"E1": (1, 4, 63, 64, 256), "E2": (1, 16, 64, 256), "E3": (1, 64, 256),
             "E4": (384, 512)}
# each form's timed calls: the rows at which it is timed on its three shapes
FORM_TIMED = {"E1": (1, 256), "E2": (1, 256), "E3": (1, 256), "E4": (512,)}
FORM_SOURCES = {
    "E1": "tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu + decode_matmul.cuh (K1, EXT); "
          "qgemm_large.cu (K3)",
    "E2": "tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu + decode_matmul.cuh (K4); "
          "qgemm_grouped_large.cu, _f32.cu (K4L)",
    "E3": "tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu (k4_native_kernel: bf16 x below 64 "
          "rows, f32 x at any N); qgemm_grouped_large_native.cu (K4L, NATIVE: bf16 x)",
    "E4": "tmac_tpu_torch/ops/cuda/csrc/qgemm_large.cu (K5)"}


def form_fns():
    """{form: (wrapper, plain version)} of E1-E4 (ops.qgemm.form)."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as gk
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
    return {"E1": (k1.qgemm_int8_x, k1.int8_x_plain),
            "E2": (gk.qgemm_grouped_ext, gk.grouped_ext_plain),
            "E3": (gk.qgemm_native, gk.native_plain),
            "E4": (gk.qgemm_dequant_ext, gk.dequant_ext_plain)}


def form_counts():
    return {f: fns[0].launches for f, fns in form_fns().items()}


def zero_form_counts():
    for kernel, _ in form_fns().values():
        kernel.launches = 0


def check_form(card, form, label, x, qt, **kw):
    """One E form on the card against its plain version: E1 and E2 bit for
    bit; E3 within native_bound (sqrt(chunk) * 2^-23 * sum |x * w|: only a
    chunk's f32 sum order differs); E4 within k5_bound, K5's gate.  -> the
    row (max_abs_err, max_ratio of the error to its bound)."""
    import torch
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as gk
    from tmac_tpu_torch.ops.qgemm import pad_x_for, route
    kernel, plain = form_fns()[form]
    got, want = kernel(x, qt, **kw), plain(x, qt, **kw)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    row = dict(form=form, shape=label, bits=qt.bits, N=x.shape[0],
               kernel="K4" if form == "E3" and x.dtype == torch.float32 else
               route(qt, x.shape[0], act="native" if form == "E3" else "auto",
                     x_int8=x.dtype == torch.int8),
               max_abs_err=float(diff.max()))
    if form in ("E1", "E2"):
        ok = row["bitwise"] = bool(torch.equal(got, want))
    else:
        if form == "E3":
            bound = gk.native_bound(x, qt)
        else:
            xa = pad_x_for(x.to(torch.bfloat16), qt)
            bound = qt.slice_m(k5_bound(xa, gk.dequant_weights_plain(qt)))
        row["max_ratio"] = float((diff / bound.clamp_min(1e-30)).max())
        ok = row["within_bound"] = bool((diff <= bound).all())
    if not ok:
        raise AssertionError(f"{form} {label} N={x.shape[0]}: {row}")
    return row


def form_bytes(x, qt):
    """Bytes one E call must move: packed weights (both planes at bits 3),
    scales and sub, x and the f32 output, each once."""
    hi = qt.packed_hi.numel() if qt.packed_hi is not None else 0
    return (qt.packed.numel() + hi + 2 * qt.scales.numel() * qt.scales.element_size()
            + x.numel() * x.element_size() + 4 * x.shape[0] * qt.mdim_padded)


def time_form(card, form, x, qt):
    """One E call's device ms (a CUDA graph of it), its plain version's
    (eager), its bound (bytes at the card's rate; 2 N Kp Mp operations at
    the int8 peak for E1, E2, the bf16 one for E3, E4) and the yardstick:
    x in bf16 times the bf16 dequantized weights, one torch.matmul
    (ops.qgemm.dequant_baseline_matmul's product)."""
    import torch
    from tmac_tpu_torch.ops.qgemm import dequant_bf16, pad_x_for
    kernel, plain = form_fns()[form]
    N = x.shape[0]
    ms = graph_ms(lambda: kernel(x, qt))
    plain_ms = cuda_ms(lambda: plain(x, qt), 1)
    ops = 2 * N * qt.kdim_padded * qt.mdim_padded
    peak = card.int8_peak if form in ("E1", "E2") else card.bf16_peak
    w = dequant_bf16(qt)
    xb = pad_x_for(x.to(torch.bfloat16), qt)
    lib = graph_ms(lambda: torch.matmul(xb, w))
    nbytes = form_bytes(x, qt)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=card.bound_ms(nbytes, ops, peak),
                bound_by="bytes" if nbytes / card.bw >= ops / peak else "operations",
                library_ms=lib)


def act_form_checks(card):
    """E1-E4 at full width against their plain versions (check_form), then
    timed: E1 on BitNet-3B's three linears (ternary weights, int8 x) at
    FORM_ROWS["E1"] rows, and one scale row with bf16 x (E2 through
    as_grouped) at 1 and 64; E2, E3 and E4 on Llama-2-7B's three at bits 2
    and 4, g128 (bf16 x), E2 also at ags 32 on 4096 x 4096 and with int8 x
    at 1 and 64 rows.  -> (check rows, per-form records of the timed calls
    summed over FORM_TIMED's rows on the three shapes, bits 2; the largest
    error by form)."""
    import torch
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(19)
    rows, worst = [], collections.defaultdict(float)
    timed = {f: collections.defaultdict(float) for f in FORM_ROWS}
    # each form's summed bound ms by what bounds it (bytes, operations)
    bound_by = {f: collections.defaultdict(float) for f in FORM_ROWS}

    def x_for(K, N, int8=False):
        if int8:
            return torch.randint(-127, 128, (N, K), generator=gen, device=card.dev,
                                 dtype=torch.int8)
        return torch.randn((N, K), generator=gen, device=card.dev).to(torch.bfloat16)

    def run(form, label, qt, N, int8=False, time_it=False, **kw):
        x = x_for(qt.kdim, N, int8)
        row = check_form(card, form, label, x, qt, **kw)
        rows.append(row)
        worst[form] = max(worst[form], row["max_abs_err"])
        if time_it:
            t = time_form(card, form, x, qt)
            row.update(t)
            bound_by[form][t["bound_by"]] += t["bound_ms"]
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                timed[form][k] += t[k]

    for K, M in TOOLS_BITNET:
        qt = wa8_qt_on_card(gen, K, M, card.dev)
        for N in FORM_ROWS["E1"]:
            run("E1", f"bitnet {K}x{M}", qt, N, int8=True, time_it=N in FORM_TIMED["E1"])
        for N in (1, 64):
            run("E2", f"bitnet {K}x{M} one scale row", qt, N)
        del qt
    for bits in (2, 4):
        for K, M in TOOLS_LLAMA:
            qt = rand_qt_on_card(gen, K, M, bits, 128, card.dev)
            label = f"llama-2-7b {K}x{M}"
            for form in ("E2", "E3", "E4"):
                for N in FORM_ROWS[form]:
                    run(form, label, qt, N, time_it=bits == 2 and N in FORM_TIMED[form])
            for N in (1, 64):
                run("E2", label + " int8 x", qt, N, int8=True)
            if (K, M) == (4096, 4096):
                for N in (1, 64):
                    run("E2", label + " ags 32", qt, N, act_gs=32)
            del qt
            torch.cuda.empty_cache()
    records = {f: dict(timed[f], bound_by=max(bound_by[f], key=bound_by[f].get))
               for f in FORM_ROWS}
    return rows, records, dict(worst)


# the CLI's checkpoint: BitNet-3B at full width, its depth cut to this many
# of its 26 layers (the subcommands' load, prefill and steps scale with it)
TOOLS_CKPT_LAYERS = 4
# the gate rows of tools/parity.py run on the card, at scaled(8)
TOOLS_PARITY = ("bitnet-3b-w1.58", "llama-2-7b-w2")


def tools_run(card, tmp):
    """The port's tools in-process on the card (the phase's main run: E1-E4
    are counted here; profile and autotune run with --min-work 0, so their
    timed chains keep --iters calls and the counts are the same in every
    run): profile on Llama-2-7B's linears at N = 1, 256, 512
    (act "auto": E2 and E4) and, with --act native, at 1 and 256 (E3), and
    on BitNet-3B's at 1 and 256 (int8 x: E1), each CSV printed as a JSON
    line; microbench; autotune on Llama-2-7B at N = 1 and 256 into a
    temporary table, then one call of each tuned shape that reads the
    table, held to its plain version bit for bit; parity on TOOLS_PARITY
    at scaled(8), after every tensor's form is checked against what the
    kernels take.  -> the seconds of each step."""
    import os

    import torch
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import init_params
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import weights_form_error
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor, kernel_for, route
    from tmac_tpu_torch.ops import tune_table
    from tmac_tpu_torch.tools import autotune, microbench, parity, profile_kernels
    seconds = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    for tag, preset, ns, act in (("llama-2-7b", "llama-2-7b", ("1", "256", "512"), "auto"),
                                 ("llama-2-7b native", "llama-2-7b", ("1", "256"), "native"),
                                 ("bitnet-3b", "bitnet-3b", ("1", "256"), "auto")):
        out = os.path.join(tmp, "profile.csv")
        rows = step("profile " + tag, lambda: profile_kernels.main(
            ["--preset", preset, "--n", *ns, "--act", act, "--iters", "10", "--min-work", "0",
             "--out", out]))
        n_rows = len(profile_kernels.SHAPE_PRESETS[preset]) * len(ns)
        if len(rows) != n_rows:
            raise AssertionError(f"profile {tag}: {len(rows)} rows of {n_rows}")
        with open(out) as f:
            say("tools_profile", preset=tag, card=card.name, nvidia_smi=card.smi,
                csv=f.read().splitlines())
    say("tools_microbench", card=card.name, nvidia_smi=card.smi,
        rows=step("microbench", lambda: microbench.main([])))

    table = os.path.join(tmp, "tune_table.json")
    os.environ["TMAC_TORCH_TUNE_TABLE"] = table
    tune_table.invalidate_cache()
    try:
        tuned = step("autotune", lambda: autotune.main(
            ["--preset", "llama-2-7b", "--n", "1", "256", "--iters", "20", "--min-work", "0"]))
        reads = []
        cfg = get_preset("llama-2-7b")
        for r in tuned:
            qt = profile_kernels._weights(cfg.quant.bits, r["M"], r["K"], "w_fp",
                                          cfg.quant.group_size, card.dev)
            x = card.bf16(r["N"], r["K"])
            got = kernel_for(qt, r["N"])(x, qt)
            want = kernel_for(qt, r["N"], plain=True)(x, qt)
            torch.cuda.synchronize()
            kern = route(qt, r["N"])
            reads.append(dict(K=r["K"], M=r["M"], N=r["N"], best=r["best"], kernel=kern,
                              passed=autotune._gate(kern, got, want, x, qt)))
            if not reads[-1]["passed"]:
                raise AssertionError(f"tuned call {reads[-1]} fails its parity gate")
        with open(table) as f:
            say("tools_autotune", card=card.name, nvidia_smi=card.smi, rows=tuned,
                reads=reads, table=json.load(f))
    finally:
        del os.environ["TMAC_TORCH_TUNE_TABLE"]
        tune_table.invalidate_cache()

    configs = [c for c in parity.GATE_CONFIGS if c[0] in TOOLS_PARITY]
    for label, name, kw in configs:
        params = init_params(get_preset(name, **kw).scaled(8), seed=0, device="cpu")
        for li, layer in enumerate(params["layers"]):
            for key, qt in layer.items():
                if isinstance(qt, QuantizedTensor) and qt.scales.shape[0] > 1 and \
                        weights_form_error(qt) is not None:
                    raise AssertionError(f"parity {label} layer {li} {key}: "
                                         f"{weights_form_error(qt)}")
    rows = step("parity", lambda: parity.run_gate(configs, scale=8, device="cuda"))
    say("tools_parity", card=card.name, nvidia_smi=card.smi, table=parity.format_table(rows),
        rows=rows)
    for r in rows:
        if not (r["nmse"] < 2e-3 and r["layer_nmse_max"] < 2e-3
                and r["agree_tie_aware"] == 1.0):
            raise AssertionError(f"parity {r['preset']}: {r}")
    return seconds


def cli_run(card, tmp):
    """The CLI in-process on a BitNet-3B checkpoint (full width,
    TOOLS_CKPT_LAYERS layers, weights drawn on the card, saved with the
    checkpoint writer): generate (16 tokens), ppl (two 256-token windows,
    K3; its NLL equal to the plain versions' on the same model within
    1e-6), score, bench-e2e and trace (a Chrome trace with device time).
    -> the subcommands' outputs and seconds."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch
    from tmac_tpu_torch.convert.checkpoint import save_checkpoint
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import Llama
    from tmac_tpu_torch.runtime.perplexity import perplexity
    from tmac_tpu_torch.tools import cli
    cfg = dataclasses.replace(get_preset("bitnet-3b"), num_layers=TOOLS_CKPT_LAYERS)
    params = params_on_card(cfg, 0, card.dev)
    ckpt = os.path.join(tmp, "bitnet-3b")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, cfg, params)
    out = {"save_s": round(time.perf_counter() - t0, 3)}
    stream = np.random.default_rng(0).integers(0, cfg.vocab_size, 512).astype(np.int32)
    np.save(os.path.join(tmp, "toks.npy"), stream)

    def run(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(list(argv))
        out[argv[0] + "_s"] = round(time.perf_counter() - t0, 3)
        return buf.getvalue().strip().splitlines()

    prompt = ",".join(str(t) for t in stream[:16])
    out["generate"] = [int(t) for t in run("generate", "--ckpt", ckpt, "--prompt-ids", prompt,
                                           "-n", "16")[-1].split(",")]
    out["ppl"] = json.loads(run("ppl", "--ckpt", ckpt, "--tokens",
                                os.path.join(tmp, "toks.npy"), "--window", "256")[-1])
    out["score"] = json.loads(run("score", "--ckpt", ckpt, "--context-ids", prompt,
                                  "--continuation-ids", "1,2,3;4")[-1])
    out["bench_e2e"] = run("bench-e2e", "--ckpt", ckpt, "--prompt-len", "16",
                           "--steps", "32")
    out["trace"] = json.loads(run("trace", "--ckpt", ckpt, "--steps", "8", "--out",
                                  os.path.join(tmp, "trace.json"))[-1])
    with torch.no_grad():
        plain = perplexity(Llama(cfg, params, plain=True), stream, window=256)
    out["ppl_plain"] = plain
    ok = (len(out["generate"]) == 16 and out["ppl"]["tokens"] == 510
          and abs(out["ppl"]["nll"] - plain["nll"]) <= 1e-6 * plain["nll"]
          and len(out["score"]) == 2 and float(out["bench_e2e"][1].split(",")[4]) > 0
          and out["trace"]["events"] > 0)
    if not ok:
        raise AssertionError(f"the CLI on the checkpoint: {out}")
    return out


def tools_path(card):
    """The phase: act_form_checks (E1-E4 against their plain versions at
    full width, timed), then with every E form's count at 0 the tools'
    run (tools_run), the counts read after it (each E form launched), then
    the CLI on a checkpoint (cli_run).  -> the kernels line's E1-E4
    records."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    rows, records, worst = act_form_checks(card)
    say("act_forms", card=card.name, nvidia_smi=card.smi, checks=rows, records=records,
        max_abs_err=worst, s=round(time.perf_counter() - t0, 3))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        zero_form_counts()
        seconds = tools_run(card, tmp)
        launches = form_counts()
        if not all(launches.values()):
            raise AssertionError(f"the tools' run launched no E form of {launches}")
        t1 = time.perf_counter()
        cli_out = cli_run(card, tmp)
        seconds["cli"] = round(time.perf_counter() - t1, 3)
    torch.cuda.empty_cache()
    say("tools_path", card=card.name, nvidia_smi=card.smi, launches=launches, cli=cli_out,
        seconds=seconds, s=round(time.perf_counter() - t0, 3))
    replaces = "tmac_tpu/ops/pallas/qgemm_kernel.py:428"
    return [dict(name=f"qgemm_pallas external form ({f})", path="tools", route="cuda",
                 source=FORM_SOURCES[f], replaces=replaces, launches=launches[f],
                 max_abs_err=worst[f], **records[f]) for f in FORM_ROWS]


# ---------------------------------------------------------------------------
# lut_forms: the last kernel forms (K10 at bits 1 and 4, E3 on f32 x, one
# scale row at bits 8 at 64 rows and more)
# ---------------------------------------------------------------------------

# K10 at BitNet-3B's layer shapes (wo 3200 x 3200, gate_up 3200 x 17280,
# down 8640 x 3200) at each bits; E3 on f32 x at LUT_F32_ROWS rows on
# Llama-2-7B's linears (bits 2, g128); one scale row at bits 8 (Llama-2-7B's
# int8 head, 4096 x 32000) at LUT_ONE_ROW_ROWS rows, act "int8" (E2) and
# "native" (E3), and E2 also at one row (K4L's one-unit fold takes it at
# any N)
LUT_K10_BITS = (1, 2, 4)
LUT_F32_ROWS = (1, 256)
LUT_ONE_ROW_ROWS = (64, 256)


def time_lut_form(card, form, x, qt):
    """One E call on the lut_forms shapes: device ms (a CUDA graph of it),
    the plain version's (eager), the bound (bytes once at the card's rate;
    operations 2 N Kp Mp at the int8 peak for E2, at the bf16 peak for E3,
    three times that for f32 x: the three exact bf16 products a value that
    the card's fastest exact method takes) and one PyTorch matmul computing
    the same function on the same inputs: x in its own dtype times the
    dequantized weights in that dtype (bf16 for E2's int8 products)."""
    import torch
    from tmac_tpu_torch.ops.qgemm import dequant_bf16, pad_x_for
    kernel, plain = form_fns()[form]
    N = x.shape[0]
    ms = graph_ms(lambda: kernel(x, qt))
    plain_ms = cuda_ms(lambda: plain(x, qt), 1)
    f32 = x.dtype == torch.float32
    ops = 2 * N * qt.kdim_padded * qt.mdim_padded * (3 if f32 else 1)
    peak = card.int8_peak if form == "E2" else card.bf16_peak
    w = dequant_bf16(qt).to(x.dtype if f32 else torch.bfloat16)
    xb = pad_x_for(x if f32 else x.to(torch.bfloat16), qt)
    lib = graph_ms(lambda: torch.matmul(xb, w))
    nbytes = form_bytes(x, qt)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=card.bound_ms(nbytes, ops, peak),
                bound_by="bytes" if nbytes / card.bw >= ops / peak else "operations",
                library_ms=lib)


def lut_forms(card):
    """The phase lut_forms: K10 at bits 1, 2 and 4 on BitNet-3B's shapes
    (two layers, bit for bit at every grid of K10_BLOCKS, then timed), E3
    on f32 x at LUT_F32_ROWS rows on Llama-2-7B's three linears and one
    scale row at bits 8 (E2 bit for bit, E3 within native_bound), each
    against its plain version and timed.  -> the kernels line's records
    (launches: the checks' and timings' calls)."""
    import torch
    from tmac_tpu_torch.ops.cuda import block_kernel as k10
    t0 = time.perf_counter()
    gen = torch.Generator(device=card.dev)
    gen.manual_seed(20)
    records, rows = [], {}
    for bits in LUT_K10_BITS:
        k10.wo_mlp_block.launches = 0
        layers = [(card.bf16(1, 3200), card.bf16(1, 3200),
                   (1.0 + 0.1 * card.bf16(3200)).to(torch.bfloat16),
                   pt_qt_on_card(gen, 3200, 3200, bits, card.dev, zero_point=False),
                   pt_qt_on_card(gen, 3200, 17280, bits, card.dev, zero_point=False),
                   pt_qt_on_card(gen, 8640, 3200, bits, card.dev, zero_point=False), 1e-5)
                  for _ in range(2)]
        checks, worst = check_k10(card, [(f"bitnet-3b bits {bits} layer {i}", layers[i])
                                         for i in (0, 1)])
        t = time_k10(card, layers)
        rows[f"k10_bits{bits}"] = dict(checks=checks, **t)
        records.append(dict(
            name=f"wo_mlp_block (K10) bits {bits}", path="lut_forms", route="cuda",
            source="tmac_tpu_torch/ops/cuda/csrc/block_kernel.cu",
            replaces="tmac_tpu/ops/pallas/block_kernel.py:222",
            launches=k10.wo_mlp_block.launches, max_abs_err=worst, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by="bytes",
            library_ms=None))
        del layers
    torch.cuda.empty_cache()

    def run(tag, form, cases):
        """cases: (label, x, qt); each checked, then timed; -> the record."""
        zero_form_counts()
        out, worst = [], 0.0
        tot = collections.defaultdict(float)
        by = collections.defaultdict(float)
        for label, x, qt in cases:
            row = check_form(card, form, label, x, qt)
            row.update(time_lut_form(card, form, x, qt))
            worst = max(worst, row["max_abs_err"])
            by[row["bound_by"]] += row["bound_ms"]
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                tot[k] += row[k]
            out.append(row)
        rows[tag] = out
        return dict(name=f"qgemm_pallas {tag}", path="lut_forms", route="cuda",
                    source=FORM_SOURCES[form],
                    replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:428",
                    launches=form_counts()[form], max_abs_err=worst,
                    bound_by=max(by, key=by.get), **tot)

    llama = [(K, M, rand_qt_on_card(gen, K, M, 2, 128, card.dev)) for K, M in TOOLS_LLAMA]
    records.append(run("E3 on f32 x", "E3", [
        (f"llama-2-7b {K}x{M} f32 x", torch.randn((N, K), generator=gen, device=card.dev), qt)
        for K, M, qt in llama for N in LUT_F32_ROWS]))
    del llama
    head = int8_head_on_card(gen, 4096, 32000, card.dev)
    for form, act in (("E2", "int8"), ("E3", "native")):
        ns = (1,) + LUT_ONE_ROW_ROWS if form == "E2" else LUT_ONE_ROW_ROWS
        records.append(run(f"{form} bits 8 one scale row ({act})", form, [
            (f"int8 head 4096x32000 ({act})", card.bf16(N, 4096), head) for N in ns]))
    torch.cuda.empty_cache()
    say("lut_forms", card=card.name, nvidia_smi=card.smi, rows=rows,
        s=round(time.perf_counter() - t0, 3))
    return records


# ---------------------------------------------------------------------------
# attn_forms: decode attention (K2, K6, K8, K9) at a cache head_dim above
# 128 and at more than 8 query heads per KV head; Mistral-Large-Instruct-
# 2407's widths (rep 12) through decode_loop
# ---------------------------------------------------------------------------

# (cache head_dim, head_dim, query heads per KV head, KV heads): Dp 256 at
# Dl 256 and 200, rep 12 and 16 at Dp 128, rep 12 at Dp 256, and Dp 384
# and 512 (two rep tiles each)
ATTN_FORMS = ((256, 256, 2, 8), (256, 200, 4, 8), (128, 128, 12, 8), (128, 128, 16, 4),
              (256, 256, 12, 8), (384, 320, 3, 8), (512, 500, 2, 8))
# the checks' cache: ATTN_S rows, lengths ATTN_LEN (and ATTN_S for K9's store
# on row S - 1), the window ATTN_WINDOW and none, at split_plan's cluster
# size and at ATTN_SPLITS
ATTN_S, ATTN_LEN, ATTN_WINDOW, ATTN_SPLITS = 2048, 2047, 1000, (None, 3)
# Mistral-Large-Instruct-2407 (its config.json: hidden 12288, 96 heads over 8
# KV heads, head_dim 128, FFN 28672, vocab 32768, rope theta 1e6; 88 layers)
# at MISTRAL_LAYERS layers, W2 g128; a 256-token prompt (K4L) and 64 steps
MISTRAL_SHAPE = dict(name="mistral-large-2407", hidden_size=12288, num_heads=96,
                     num_kv_heads=8, head_dim=128, intermediate_size=28672,
                     vocab_size=32768, rope_theta=1e6, max_position_embeddings=131072)
MISTRAL_LAYERS, MISTRAL_PROMPT = 2, 256
ATTN_FNS = ("K2", "K6", "K8", "K9")


def form_cache(card, Dp, Dl, KV, quant, L=2):
    """A random (L, 1, KV, ATTN_S, Dp) cache, zero past Dl: int8 codes with
    their f32 scales, or bf16 values (scales None)."""
    import torch
    from tmac_tpu_torch.ops.cuda.attention_kernel import quantize_kv
    kv = torch.nn.functional.pad(torch.randn((2, L, 1, KV, ATTN_S, Dl), device=card.dev),
                                 (0, Dp - Dl))
    if not quant:
        kv = kv.to(torch.bfloat16)
        return kv[0].contiguous(), kv[1].contiguous(), None, None
    codes, sc = quantize_kv(kv)
    return codes[0].contiguous(), codes[1].contiguous(), sc[0].contiguous(), sc[1].contiguous()


def attn_fn_call(name, plain, q, cache, lens, li, cur, window, nsplit=None):
    """One call of K2/K6/K8/K9 (or its plain version) on `cache` (k, v,
    k_scale, v_scale; K9 stores into it); -> the output."""
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    k, v, ks, vs = cache
    kw = dict(k_scale=ks, v_scale=vs, window=window, nsplit=nsplit)
    fn = {"K2": ak.flash_decode, "K6": ak.flash_decode_split, "K8": ak.flash_decode_append,
          "K9": ak.flash_decode_append_write}[name]
    if plain:
        fn = {"K2": ak.flash_decode_plain, "K6": ak.flash_decode_split_plain,
              "K8": ak.flash_decode_append_plain,
              "K9": ak.flash_decode_append_write_plain}[name]
    args = (q, k, v, lens, li) + ((cur[0], cur[1]) if name in ("K8", "K9") else ())
    return fn(*args, **kw)


def check_attn_forms(card):
    """K2, K6, K8 and K9 at each of ATTN_FORMS against their plain versions,
    bit for bit: bf16 and int8 caches, the window and none (K2: bf16, no
    window; K6: the other three), at ATTN_LEN rows (K9 also at ATTN_S: its
    store on row S - 1, which every rep tile's cluster reads, by the last
    one to finish), at ATTN_SPLITS; K9 on two copies of the cache, every
    byte of the two equal after.  -> (rows, worst abs error by kernel)"""
    import torch
    dev = card.dev
    li = torch.tensor([1], dtype=torch.int32, device=dev)
    rows, worst = [], dict.fromkeys(ATTN_FNS, 0.0)
    for Dp, Dl, rep, KV in ATTN_FORMS:
        q = card.bf16(1, KV, rep, Dl)
        cur = (card.bf16(1, KV, Dl), card.bf16(1, KV, Dl))
        for quant in (False, True):
            cache = form_cache(card, Dp, Dl, KV, quant)
            for window, nsplit in itertools.product((0, ATTN_WINDOW), ATTN_SPLITS):
                for name in ATTN_FNS:
                    if (name == "K2") != (not quant and not window):
                        continue
                    for n in (ATTN_LEN, ATTN_S) if name == "K9" else (ATTN_LEN,):
                        lens = torch.tensor([n], dtype=torch.int32, device=dev)
                        pair = [tuple(t.clone() if t is not None else None for t in cache)
                                for _ in range(2)] if name == "K9" else [cache, cache]
                        got = attn_fn_call(name, False, q, pair[0], lens, li, cur, window, nsplit)
                        want = attn_fn_call(name, True, q, pair[1], lens, li, cur, window, nsplit)
                        torch.cuda.synchronize()
                        err = float((got.float() - want.float()).abs().max())
                        worst[name] = max(worst[name], err)
                        stored = all(a is None or torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                                     for a, b in zip(*pair))
                        row = dict(kernel=name, Dp=Dp, Dl=Dl, rep=rep, KV=KV,
                                   cache="int8" if quant else "bf16", window=window,
                                   nsplit=nsplit, len=n, max_abs_err=err,
                                   bitwise=bool(torch.equal(got, want)), cache_equal=stored)
                        rows.append(row)
                        if not (row["bitwise"] and stored):
                            raise AssertionError(f"decode attention form check failed: {row}")
            del cache
    return rows, worst


def k9_graph_after_growth(card):
    """K9 over two rep tiles (rep 12 at Dp 128: it elects the row's writer
    through the counters) captured in a CUDA graph at one batch row; then
    one launch at more (batch row, kv head) pairs than the counter buffer
    holds, which makes a larger one; int32 blocks of the old buffer's size
    taken and filled with ones (where a freed buffer would be reused); the
    cache reset and the graph replayed.  Its output and the row it stores
    must equal the plain version's, bit for bit.  -> dict (bitwise,
    cache_equal, the counter buffer's size at the capture and after)."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    dev = card.dev
    KV, rep, D, S = 8, 12, 128, 256
    li = torch.tensor([1], dtype=torch.int32, device=dev)

    def inputs(B):
        return (card.bf16(B, KV, rep, D), card.bf16(2, B, KV, S, D), card.bf16(2, B, KV, S, D),
                torch.full((B,), S - 8, dtype=torch.int32, device=dev), card.bf16(B, KV, D),
                card.bf16(B, KV, D))
    q, k, v, lens, ck, cv = inputs(1)
    k0, v0 = k.clone(), v.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ak.flash_decode_append_write(q, k, v, lens, li, ck, cv)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ak.flash_decode_append_write(q, k, v, lens, li, ck, cv)
    n0 = ak._done[q.device][-1].numel()
    big = inputs(n0 // KV + 1)
    ak.flash_decode_append_write(big[0], big[1], big[2], big[3], li, big[4], big[5])
    grown = ak._done[q.device][-1].numel()
    hold = [torch.ones(n0, dtype=torch.int32, device=dev) for _ in range(8)]
    k.copy_(k0)
    v.copy_(v0)
    graph.replay()
    kw, vw = k0.clone(), v0.clone()
    want = ak.flash_decode_append_write_plain(q, kw, vw, lens, li, ck, cv)
    torch.cuda.synchronize()
    del hold, big
    return dict(bitwise=bool(torch.equal(out, want)),
                cache_equal=bool(torch.equal(k, kw) and torch.equal(v, vw)),
                counters_at_capture=n0, counters_after=grown)


def time_attn_form(card, name, Dp, Dl, rep, KV):
    """One call of `name` at a form, ATTN_LEN rows of a bf16 cache (K6: int8,
    no window): device ms (a CUDA graph of it), the plain version's, the
    bound (the Dl columns of each row read once and q, the current row and
    the output moved once, at the card's rate; 4 Dl operations a row and
    query head at the bf16 peak), and SDPA over the same rows (bf16, the
    int8 cache's values dequantized)."""
    import torch
    quant = name == "K6"
    cache = form_cache(card, Dp, Dl, KV, quant)
    q = card.bf16(1, KV, rep, Dl)
    cur = (card.bf16(1, KV, Dl), card.bf16(1, KV, Dl))
    li = torch.tensor([1], dtype=torch.int32, device=card.dev)
    lens = torch.tensor([ATTN_LEN], dtype=torch.int32, device=card.dev)
    ms = graph_ms(lambda: attn_fn_call(name, False, q, cache, lens, li, cur, 0))
    plain = cuda_ms(lambda: attn_fn_call(name, True, q, cache, lens, li, cur, 0), 1)
    k, v = cache[0][1, :, :, :ATTN_LEN, :Dl], cache[1][1, :, :, :ATTN_LEN, :Dl]
    if quant:
        k = (k.float() * cache[2][1, :, :, :ATTN_LEN, None]).to(torch.bfloat16)
        v = (v.float() * cache[3][1, :, :, :ATTN_LEN, None]).to(torch.bfloat16)
    qs = q.reshape(1, KV * rep, 1, Dl)
    gqa = dict(enable_gqa=True) if rep > 1 else {}
    lib = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qs, k, v, **gqa))
    item = 1 if quant else 2
    nbytes = 2 * KV * ATTN_LEN * (Dl * item + (4 if quant else 0)) + 2 * 2 * KV * rep * Dl
    if name in ("K8", "K9"):
        nbytes += 2 * 2 * KV * Dl * (2 if name == "K9" else 1)
    ops = 4 * KV * rep * ATTN_LEN * Dl
    return dict(ms=ms, plain_ms=plain, bound_ms=card.bound_ms(nbytes, ops, card.bf16_peak),
                bound_by="bytes" if nbytes / card.bw >= ops / card.bf16_peak else "operations",
                library_ms=lib)


def attn_forms(card):
    """The phase attn_forms: check_attn_forms, each form's four kernels
    timed (time_attn_form), then Mistral-Large-Instruct-2407's widths
    (MISTRAL_SHAPE: rep 12, two rep tiles of 8 in K2) at MISTRAL_LAYERS of
    its 88 layers, W2 g128, drawn on the card, through grouped_path (the
    K4, K4L, K1, K3 and K2 checks at its shapes, a MISTRAL_PROMPT-token
    prefill and 64 steps of decode_loop, teacher-forced against the plain
    path, timed).  No public Llama-family config has head_dim above 128,
    so Dp 256-512 are checked at kernel shapes only.  -> the kernels
    line's records (the forms' launches: the checks' and timings' calls)."""
    import torch
    from tmac_tpu_torch.models.config import get_preset
    t0 = time.perf_counter()
    zero_counts()
    rows, worst = check_attn_forms(card)
    growth = k9_graph_after_growth(card)
    if not (growth["bitwise"] and growth["cache_equal"]
            and growth["counters_after"] > growth["counters_at_capture"]):
        raise AssertionError(f"K9 replayed from a graph after its counters grew: {growth}")
    times = {}
    for Dp, Dl, rep, KV in ATTN_FORMS:
        for name in ATTN_FNS:
            times[(name, Dp, Dl, rep, KV)] = time_attn_form(card, name, Dp, Dl, rep, KV)
    launches = read_counts()
    checks_s = time.perf_counter() - t0
    say("attn_forms_checks", card=card.name, nvidia_smi=card.smi, rows=rows,
        k9_graph_after_growth=growth,
        times=[dict(kernel=k[0], Dp=k[1], Dl=k[2], rep=k[3], KV=k[4], **t)
               for k, t in times.items()], launches=launches, s=round(checks_s, 3))
    records = []
    for name in ATTN_FNS:
        tot = {key: sum(t[key] for k, t in times.items() if k[0] == name)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        records.append(dict(
            name=f"decode attention ({name}) Dp 128-512, rep 2-16 ({len(ATTN_FORMS)} forms)",
            path="attn_forms", route="cuda",
            source="tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
            replaces="tmac_tpu/ops/pallas/attention_kernel.py:"
                     + {"K2": "367", "K6": "367", "K8": "450", "K9": "552"}[name],
            launches=launches[name], max_abs_err=worst[name], bound_by="bytes", **tot))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_preset("llama-2-7b"), num_layers=MISTRAL_LAYERS,
                              **MISTRAL_SHAPE)
    records += grouped_path(card, "mistral_large", cfg, MISTRAL_PROMPT, MISTRAL_PROMPT,
                            k4_rows=(1, 4, 64), k5_rows=())
    torch.cuda.empty_cache()
    say("attn_forms_s", checks=round(checks_s, 3), mistral_large=round(time.perf_counter() - t1, 3),
        s=round(time.perf_counter() - t0, 3))
    return records


# ---------------------------------------------------------------------------
# path 15: tensor parallelism, Llama-2-7B W2 g128 at tp = 2 as two gloo
# ranks on the one card; BitNet-3B at tp = 2 over TP_BITNET_LAYERS layers
# ---------------------------------------------------------------------------

TP, TP_SEED = 2, 0
# one sequence: a 16-token prefill, 600 more tokens in chunks of 512 (K5:
# 512 >= 3 * 128) and 88 (K4L), then TP_STEPS greedy steps through
# make_tp_step; TP_TIMED more steps timed, TP_AR all-reduces timed alone
TP_CHUNKS, TP_STEPS, TP_TIMED = (16, 512, 88), 64, 8
TP_BITNET_LAYERS, TP_BITNET_PROMPT, TP_BITNET_STEPS = 4, 256, 4
# JAX's own tp gate (tests/test_parallel.py) and its near-tie gap; the
# noise-floor gate's factor (tp_gap)
TP_RTOL, TP_ATOL, TP_TIE = 5e-2, 0.1, 0.2
TP_FLOOR = 2.0
# a rank's hard limit: a hung rank ends the path
TP_RANK_TIMEOUT_S = 600


def tp_params_on_card(cfg, tp, seed, dev):
    """params_on_card's tree as init_params(tp=tp) packs it, drawn on the
    card (grouped weights, or per-tensor ternary ones at w_a8): the
    column-parallel linears (wqkv, gate_up) as tp m-shards of M / tp
    columns each drawn on its own, padded to a multiple of 128 and laid
    side by side (m_shards = tp), the row-parallel ones (wo, down) as tp
    k-shards of K / tp rows each drawn (and padded) on its own, stacked
    (k_shards = tp); an MoE model's experts alike (each expert's gate_up
    column-parallel, its down row-parallel, stacked).  The same seed gives
    every process the same tree."""
    import torch
    from tmac_tpu_torch.models.llama import padded_intermediate, padded_moe_intermediate
    from tmac_tpu_torch.models.moe import stack_experts
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
    from tmac_tpu_torch.utils import round_up
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    H, V, q = cfg.hidden_size, cfg.vocab_size, cfg.quant

    def draw(K, M):
        if q.mode == "w_a8":
            return wa8_qt_on_card(gen, K, M, dev)
        return rand_qt_on_card(gen, K, M, q.bits, q.group_size, dev)

    def shards(K, M, axis, kw):
        parts = [draw(K, M) for _ in range(tp)]
        pad = (lambda a: a) if axis == 0 else (
            lambda a: torch.nn.functional.pad(a, (0, round_up(M, 128) - M)))
        cat = lambda name: torch.cat([pad(getattr(p, name)) for p in parts], axis)  # noqa: E731
        return QuantizedTensor(cat("packed"), None, cat("scales"), cat("sub"), parts[0].bits,
                               parts[0].group_size, **kw)

    def col(K, M):
        return shards(K, M // tp, -1, dict(k_shards=1, m_shards=tp, shape=(K, M)))

    def row(K, M):
        return shards(K // tp, M, 0, dict(k_shards=tp, m_shards=1, shape=(K, M)))

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16)

    def mlp():
        if not cfg.num_experts:
            I = padded_intermediate(cfg, tp)
            return {"gate_up": fuse_m([col(H, I), col(H, I)]), "down": row(I, H)}
        Ie, E = padded_moe_intermediate(cfg, tp), cfg.num_experts
        return {"moe_router": normal(H, E),
                "experts_gate_up": stack_experts([fuse_m([col(H, Ie), col(H, Ie)])
                                                  for _ in range(E)]),
                "experts_down": stack_experts([row(Ie, H) for _ in range(E)])}

    ones = torch.ones(H, dtype=torch.bfloat16, device=dev)
    layers = [{"attn_norm": ones, "mlp_norm": ones,
               "wqkv": fuse_m([col(H, cfg.q_dim), col(H, cfg.kv_dim), col(H, cfg.kv_dim)]),
               "wo": row(cfg.q_dim, H), **mlp()}
              for _ in range(cfg.num_layers)]
    return {"embed": normal(V, H), "layers": layers, "final_norm": ones,
            "lm_head": int8_head_on_card(gen, H, V, dev)}


def tp_prompt(cfg, n, seed=15):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n)))


def tp_linear_calls(card, cfg, layer, N):
    """A rank's layer-0 linears at N rows as (label, x, weight, folds),
    with the folds the tp forward gives them: the norm into wqkv and
    gate_up, the SwiGLU into down where its K is unpadded, no residual (it
    joins after the group's sum)."""
    calls = []
    for sh in LINEARS:
        qt = layer[sh]
        if sh in ("wqkv", "gate_up"):
            kw = dict(norm=(layer["attn_norm" if sh == "wqkv" else "mlp_norm"],
                            cfg.rms_norm_eps))
            x = card.bf16(N, cfg.hidden_size)
        elif sh == "down" and qt.kdim_padded == qt.kdim:
            kw, x = dict(glu=True), card.bf16(N, 2 * qt.kdim)
        else:
            kw, x = {}, card.bf16(N, qt.kdim)
        calls.append((f"{sh} {qt.kdim}x{qt.mdim}", x, qt, kw))
    return calls


def tp_kernel_checks(card, cfg, layer, plan):
    """A rank's checks of its shard-local calls against the plain versions,
    each then timed: plan (kernel, N, check, timer) on tp_linear_calls' four
    linears at N rows.  -> (rows, worst error, and ms, plain, bound and
    library summed over the four linears, by kernel)."""
    rows, worst, timed = {}, {}, {}
    for kernel, N, check, timer in plan:
        cs = tp_linear_calls(card, cfg, layer, N)
        rows[kernel], worst[kernel] = check(card, cs)
        per = [timer(card, [(x, qt, kw)]) for _, x, qt, kw in cs]
        timed[kernel] = {k: sum(p[k] for p in per)
                         for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        timed[kernel]["bound_by"] = dominant_bound(per)
    return rows, worst, timed


def tp_k2_check(card, cfg, cache):
    """K2 on a rank's cache at its head shape (16 KV heads), layer 0, at
    every split of the checks, bit for bit, then timed.  -> (rows, worst
    error, record)."""
    import torch
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak
    KV, D = cfg.num_kv_heads, cfg.head_dim
    q = card.bf16(1, KV, cfg.num_heads // KV, D)
    lens, li = cache.pos.clone(), torch.tensor([0], dtype=torch.int32, device=card.dev)
    rows, worst = [], 0.0
    for nsplit in (None, 1, 8):
        got = ak.flash_decode(q, cache.k, cache.v, lens, li, nsplit=nsplit)
        want = ak.flash_decode_plain(q, cache.k, cache.v, lens, li, nsplit=nsplit)
        torch.cuda.synchronize()
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        rows.append(dict(KV=KV, rows=int(lens[0]), nsplit=nsplit,
                         bitwise=bool(torch.equal(got, want))))
        if not rows[-1]["bitwise"]:
            raise AssertionError(f"K2 at the rank's shape: {rows[-1]}")
    ms, plain, bound, lib = time_k2(card, cfg, cache, int(lens[0]))
    return rows, worst, dict(ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib,
                             bound_by="bytes")


def tp_rank(rank, d):
    """One of path 15's ranks (a process of its own, started by tp_path):
    joined to the other over gloo on the one card, it runs the Llama-2-7B
    sequence and the BitNet-3B run through make_tp_step, each with the
    launch counts zeroed before and read after, times its steps and
    all-reduces, checks its shard-local calls, and saves what it found to
    d/rank{rank}.pt."""
    import torch
    from tmac_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    launch.init("gloo", "cuda:0", init_method=f"file://{d}/rendezvous", world_size=TP,
                rank=rank)
    try:
        torch.save(tp_rank_run(rank), f"{d}/rank{rank}.pt")
    finally:
        launch.shutdown()


def tp_rank_run(rank):
    import torch
    import torch.distributed as dist
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.parallel import tp as tpmod
    card = Card()
    out = {"rank": rank}
    with torch.no_grad():
        cfg = get_preset("llama-2-7b")
        mesh = tpmod.make_mesh(tp=TP, device=card.dev)
        t0 = time.perf_counter()
        params = tp_params_on_card(cfg, TP, TP_SEED, card.dev)
        sparams = tpmod.shard_params(params, mesh)
        del params
        torch.cuda.empty_cache()
        prefill, decode = tpmod.make_tp_step(cfg, mesh, sparams)
        model = prefill.model
        out["init_s"] = time.perf_counter() - t0
        prompt = tp_prompt(cfg, sum(TP_CHUNKS)).to(card.dev)
        cache = KVCache.create(model.cfg, 1, sum(TP_CHUNKS) + TP_STEPS + TP_TIMED,
                               device=card.dev)
        torch.cuda.synchronize()
        zero_counts()
        t0, chunk_logits, a = time.perf_counter(), [], 0
        for n in TP_CHUNKS:
            lg, cache = prefill(prompt[:, a:a + n], cache)
            chunk_logits.append(lg)
            a += n
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        first = torch.argmax(chunk_logits[-1], -1).to(torch.int32)
        t0 = time.perf_counter()
        toks, cache, step_logits = decode(first, cache, 0, TP_STEPS, return_logits=True)
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["launches"] = read_counts()
        out.update(first=first.cpu(), toks=toks.cpu(), chunk_logits=[c.cpu() for c in chunk_logits],
                   step_logits=step_logits.cpu(), local_heads=model.cfg.num_heads,
                   finite=bool(torch.isfinite(step_logits).all()))
        # the step's time (CUDA events and the host's clock over TP_TIMED
        # more steps), and the all-reduces of a step alone (2 a layer)
        t0 = time.perf_counter()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, cache = decode(toks[:, -1], cache, 0, TP_TIMED)
        stop.record()
        torch.cuda.synchronize()
        out["step_ms_events"] = start.elapsed_time(stop) / TP_TIMED
        out["step_ms_wall"] = (time.perf_counter() - t0) * 1e3 / TP_TIMED
        buf = torch.zeros((1, cfg.hidden_size), dtype=torch.bfloat16, device=card.dev)
        dist.all_reduce(buf, group=mesh.tp_group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(2 * cfg.num_layers):
            dist.all_reduce(buf, group=mesh.tp_group)
        stop.record()
        torch.cuda.synchronize()
        out["allreduce_ms_events"] = start.elapsed_time(stop)
        out["allreduce_ms_wall"] = (time.perf_counter() - t0) * 1e3
        out["checks"], out["worst"], out["timed"] = tp_kernel_checks(
            card, model.cfg, model_layer(model, 0),
            (("K4", 1, check_k4, time_k4), ("K4L", 88, check_k4, time_k4),
             ("K5", 512, check_k5, time_k5)))
        out["checks"]["K2"], out["worst"]["K2"], out["timed"]["K2"] = tp_k2_check(
            card, model.cfg, cache)
        del model, prefill, decode, sparams, cache
        torch.cuda.empty_cache()

        # BitNet-3B at tp = 2 over its first TP_BITNET_LAYERS layers
        cfg_b = dataclasses.replace(get_preset("bitnet-3b"), num_layers=TP_BITNET_LAYERS)
        t0 = time.perf_counter()
        params = tp_params_on_card(cfg_b, TP, TP_SEED, card.dev)
        prefill, decode = tpmod.make_tp_step(cfg_b, mesh, tpmod.shard_params(params, mesh))
        del params
        out["bitnet_init_s"] = time.perf_counter() - t0
        cache = KVCache.create(prefill.model.cfg, 1, TP_BITNET_PROMPT + TP_BITNET_STEPS,
                               device=card.dev)
        zero_counts()
        lg, cache = prefill(tp_prompt(cfg_b, TP_BITNET_PROMPT).to(card.dev), cache)
        btoks, cache, blog = decode(torch.argmax(lg, -1).to(torch.int32), cache, 0,
                                    TP_BITNET_STEPS, return_logits=True)
        torch.cuda.synchronize()
        out["bitnet_launches"] = read_counts()
        out["bitnet_toks"] = btoks.cpu()
        out["bitnet_finite"] = bool(torch.isfinite(blog).all() and torch.isfinite(lg).all())
        out["bitnet_checks"], out["bitnet_worst"], out["bitnet_timed"] = tp_kernel_checks(
            card, prefill.model.cfg, model_layer(prefill.model, 0),
            (("K1", 1, check_k1, time_k4), ("K3", TP_BITNET_PROMPT, check_k3, time_k3)))
    return out


def model_layer(model, i):
    """Layer i of a Llama as the dict of its parameters (QuantizedTensors
    and norms) that the checks take."""
    blk = model.layers[i]
    return {"wqkv": blk.wqkv.qt, "wo": blk.wo.qt, "gate_up": blk.gate_up.qt,
            "down": blk.down.qt, "attn_norm": blk.attn_norm, "mlp_norm": blk.mlp_norm}


def shard_sum_linear(apply_qlinear):
    """models/llama.py's apply_qlinear (given: the module's own) as the tp
    ranks compute a row-parallel tensor (k_shards > 1), on one device: each
    shard (QuantizedTensor.k_shard, what a rank holds) through its kernel
    on its slice of x (both SwiGLU halves' slices under glu), the outputs
    in x's dtype added in shard order, the residual after; any other
    tensor as apply_qlinear."""
    import torch

    def shard_sum(x, qt, norm=None, glu=False, residual=None, plain=False, act_gs=0,
                  mode=None):
        kw = dict(plain=plain, act_gs=act_gs, mode=mode)
        if qt.k_shards == 1:
            return apply_qlinear(x, qt, norm=norm, glu=glu, residual=residual, **kw)
        ks, out = qt.kdim // qt.k_shards, None
        for s in range(qt.k_shards):
            xs = x[..., s * ks:(s + 1) * ks]
            if glu:
                xs = torch.cat([xs, x[..., qt.kdim + s * ks:qt.kdim + (s + 1) * ks]], -1)
            o = apply_qlinear(xs.contiguous(), qt.k_shard(s), glu=glu, **kw)
            out = o if out is None else out + o
        return out if residual is None else residual + out
    return shard_sum


def tp_shard_sum_reference(cfg, params):
    """Path 15's exact check: the port's Llama over the whole tp-packed tree
    in one process, computing what the ranks compute: wo and down as the
    sum of their shards' kernels (shard_sum_linear in place of
    apply_qlinear during its forward), decode attention at the ranks'
    split (split_plan at TP's share of the KV heads, forced with nsplit)
    and prefill attention a rank's share of the heads at a time.  What
    remains is the distribution (the process group, the sharded weights
    and caches, each rank's shapes), so the ranks equal it bit for bit.
    The single-device forward is Llama(cfg, params) itself (its k-sharded
    wo and down on the JAX package's XLA route, one fold over all shards)."""
    import torch
    from tmac_tpu_torch.models import llama
    from tmac_tpu_torch.ops.cuda import attention_kernel as ak

    class TPSumReference(llama.Llama):
        def forward(self, *args, **kwargs):
            apply_qlinear = llama.apply_qlinear
            llama.apply_qlinear = shard_sum_linear(apply_qlinear)
            try:
                return super().forward(*args, **kwargs)
            finally:
                llama.apply_qlinear = apply_qlinear

        def _decode_attention(self, q, k, v, cache, li, lens):
            B, _, H, D = q.shape
            KV, S = cache.k.shape[2], cache.k.shape[3]
            nsplit = ak._nsplit(None, B, KV // TP, S, self.cfg.sliding_window, q.device)
            o = self.attend(q.reshape(B, KV, H // KV, D), cache.k, cache.v, lens,
                            self.layer_ids[li:li + 1], scale=1.0 / math.sqrt(D),
                            window=self.cfg.sliding_window, nsplit=nsplit)
            return o.reshape(B, 1, H * D)

        def _prefill_attention(self, q, cache, li, positions, kv_len_mask):
            H, KV = q.shape[2], cache.k.shape[2]
            parts = []
            for s in range(TP):
                kvs = slice(s * KV // TP, (s + 1) * KV // TP)
                view = llama.KVCache(k=cache.k[:, :, kvs], v=cache.v[:, :, kvs], pos=cache.pos)
                parts.append(super()._prefill_attention(
                    q[:, :, s * H // TP:(s + 1) * H // TP], view, li, positions, kv_len_mask))
            return torch.cat(parts, -1)

    return TPSumReference(cfg, params)


def tp_forced(card, model, cfg, inputs, tok):
    """model teacher-forced along path 15's sequence: the prompt in
    TP_CHUNKS, then inputs (1, TP_STEPS) a token a step.  -> (logits of
    each chunk's last position and of each step (P, V) f32 numpy, the eager
    step's ms over TP_TIMED more steps of tok (CUDA events))."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    prompt = tp_prompt(cfg, sum(TP_CHUNKS)).to(card.dev)
    cache = KVCache.create(cfg, 1, sum(TP_CHUNKS) + TP_STEPS + TP_TIMED, device=card.dev)
    want, a = [], 0
    for n in TP_CHUNKS:
        lg, cache = model(prompt[:, a:a + n], cache)
        want.append(lg[:, -1].float().cpu())
        a += n
    inputs, tok = inputs.to(card.dev), tok.to(card.dev)
    for i in range(TP_STEPS):
        lg, cache = model(inputs[:, i:i + 1], cache)
        want.append(lg[:, -1].float().cpu())
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(TP_TIMED):
        model(tok, cache)
    stop.record()
    torch.cuda.synchronize()
    return torch.cat(want).numpy(), start.elapsed_time(stop) / TP_TIMED


def rel_rms(a, b):
    """Each row's rms difference of logits a and b over b's rms."""
    import numpy as np
    return np.sqrt(((a - b) ** 2).mean(-1) / (b ** 2).mean(-1))


def tp_gap(want, got, floor, toks, chunks):
    """The tp logits got against the single-device forward's want (P, V),
    both along the tp tokens toks (the first chunks rows are prompt chunks'
    last positions; toks[i] is what row chunks - 1 + i chose), with floor
    the port's other single-device forward's logits along them (the
    unsharded tree on the kernels).  Reported: JAX's tp gate as
    tests/test_parallel.py states it (the prefill logits, here each
    chunk's last position, within rtol TP_RTOL and atol TP_ATOL; the tp
    tokens the reference's argmax at >= 75% of the steps, each other one a
    near-tie, its lead below TP_TIE) and the gap it shows (the largest
    difference, the share of logits outside the tolerance, each
    position's rms difference over the reference's rms, the leads the tp
    tokens miss), beside floor's against want.  Held: the noise-floor
    gate, the tp logits' mean relative rms difference from want at most
    TP_FLOOR times floor's (a random 32-layer model carries any rounding
    difference far: two single-device forwards of the same weights part
    as far as tp does)."""
    import numpy as np
    diff = np.abs(got - want)
    outside = diff > TP_ATOL + TP_RTOL * np.abs(want)
    rel, rel_floor = rel_rms(got, want), rel_rms(floor, want)
    ref = want[chunks - 1:]
    lead = ref.max(-1) - ref[np.arange(len(toks)), toks]
    agree = float((ref.argmax(-1) == toks).mean())
    jax_gate = bool(not outside[:chunks].any() and agree >= 0.75 and
                    np.all(lead[ref.argmax(-1) != toks] < TP_TIE))
    return dict(max_abs_diff=float(diff.max()), share_outside=float(outside.mean()),
                share_outside_prefill=float(outside[:chunks].mean()),
                max_rel_rms=float(rel.max()), mean_rel_rms=float(rel.mean()),
                argmax_agreement=agree, max_missed_lead=float(lead.max()),
                near_share=float((lead < TP_TIE).mean()), jax_gate=jax_gate,
                floor_max_rel_rms=float(rel_floor.max()),
                floor_mean_rel_rms=float(rel_floor.mean()),
                floor_argmax_agreement=float((ref.argmax(-1) ==
                                              floor[chunks - 1:].argmax(-1)).mean()),
                mean_rel_rms_to_floor=float(rel_rms(got, floor).mean()),
                floor_gate=bool(rel.mean() <= TP_FLOOR * rel_floor.mean()),
                rtol=TP_RTOL, atol=TP_ATOL, tie=TP_TIE, floor_factor=TP_FLOOR)


def merge_k_shards(qt):
    """The k_shards = 1 tensor of a row-parallel one's weights: each
    shard's codes, scales and zero points without its padding, laid end to
    end and packed again (grouped scales; on the tensor's device)."""
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes
    S, gs = qt.k_shards, qt.group_size
    ks, ksp = qt.kdim // S, qt.kdim_padded // S
    codes = unpack_codes(qt).reshape(S, ksp, -1)[:, :ks].reshape(qt.kdim, -1)

    def cut(a):
        return a.reshape(S, ksp // gs, -1)[:, :ks // gs].reshape(qt.kdim // gs, -1)
    return QuantizedTensor.from_quantized(
        qt.slice_m(codes), qt.slice_m(cut(qt.scales)), qt.slice_m(cut(qt.sub)), qt.bits, gs,
        scale_dtype=qt.scales.dtype, device=qt.packed.device)


def unsharded_tree(params):
    """init_params(tp=1)'s tree of a tp-packed one's weights: its
    row-parallel linears (wo, down, each expert's down) merged
    (merge_k_shards); the
    column-parallel ones kept (an m-sharded tensor computes each column as
    its unsharded one does)."""
    from tmac_tpu_torch.models.moe import expert_view, num_local_experts, stack_experts

    def merged(lp):
        out = dict(lp, wo=merge_k_shards(lp["wo"]))
        if "down" in lp:
            out["down"] = merge_k_shards(lp["down"])
        if "experts_down" in lp:
            st = lp["experts_down"]
            out["experts_down"] = stack_experts([merge_k_shards(expert_view(st, e))
                                                 for e in range(num_local_experts(st))])
        return out
    return dict(params, layers=[merged(lp) for lp in params["layers"]])


def tp_path(card):
    """Path 15 (phase tp_path): two ranks (torch.multiprocessing, spawn)
    joined by gloo on the one card run tp_rank; then, in this process, on
    the same weights drawn from the same seed, teacher-forced along rank
    0's tokens (the three chunks' last positions and each of the TP_STEPS
    steps): tp_shard_sum_reference, which the ranks must equal bit for bit
    at every position; the single-device forward over the tp-packed tree
    (Llama(cfg, params): wo and down on the JAX package's XLA route); and
    the port's single-device forward over the same weights unsharded
    (unsharded_tree: every linear on its kernel), the noise floor: tp_gap
    reports JAX's tp gate and the gap it shows and holds the noise-floor
    gate.  Each one's eager step timed beside the ranks'.  Every
    shard-local check is the ranks'.  -> the kernels line's records."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import Llama
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(tp_rank, args=(d,), nprocs=TP, join=False,
                                 start_method="spawn")
        deadline = time.perf_counter() + TP_RANK_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"a tp rank ran past {TP_RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(TP)]
    ranks_s = time.perf_counter() - t_all
    r0 = ranks[0]
    if not (all(r["finite"] and r["bitnet_finite"] for r in ranks)
            and all(torch.equal(r["toks"], r0["toks"]) for r in ranks)):
        raise AssertionError("tp ranks: non-finite logits or ranks disagreeing on tokens")

    cfg = get_preset("llama-2-7b")
    inputs = torch.cat([r0["first"][:, None], r0["toks"][:, :-1]], 1)
    with torch.no_grad():
        params = tp_params_on_card(cfg, TP, TP_SEED, card.dev)
        exact, exact_ms = tp_forced(card, tp_shard_sum_reference(cfg, params), cfg, inputs,
                                    r0["toks"][:, -1:])
        single, single_ms = tp_forced(card, Llama(cfg, params), cfg, inputs,
                                      r0["toks"][:, -1:])
        floor, floor_ms = tp_forced(card, Llama(cfg, unsharded_tree(params)), cfg, inputs,
                                    r0["toks"][:, -1:])
        del params
        torch.cuda.empty_cache()
    got = torch.stack([c[0] for c in r0["chunk_logits"]] + list(r0["step_logits"][0])).numpy()
    toks = np.concatenate([r0["first"].numpy(), r0["toks"][0].numpy()])
    bitwise = int(np.all(got == exact, -1).sum())
    tf = dict(positions=int(got.shape[0]), bitwise_positions_shard_sum=bitwise,
              single_device=tp_gap(single, got, floor, toks, len(TP_CHUNKS)))
    launches = {k: sum(r["launches"][k] for r in ranks) for k in COUNTERS}
    bl = {k: sum(r["bitnet_launches"][k] for r in ranks) for k in COUNTERS}
    timing = dict(tp_step_ms_events=r0["step_ms_events"], tp_step_ms_wall=r0["step_ms_wall"],
                  single_device_step_ms_events=floor_ms, torch_route_step_ms_events=single_ms,
                  shard_sum_step_ms_events=exact_ms,
                  allreduce_ms_a_step_events=r0["allreduce_ms_events"],
                  allreduce_ms_a_step_wall=r0["allreduce_ms_wall"],
                  allreduce_share_wall=r0["allreduce_ms_wall"] / r0["step_ms_wall"],
                  prefill_s=r0["prefill_s"], decode_s=r0["decode_s"], init_s=r0["init_s"],
                  bitnet_init_s=r0["bitnet_init_s"], ranks_s=round(ranks_s, 3))
    say("tp_path", card=card.name, nvidia_smi=card.smi, tp=TP, backend="gloo",
        teacher_forced=tf, timing=timing, launches=launches, bitnet_launches=bl,
        local_heads=r0["local_heads"], checks=[r["checks"] for r in ranks],
        bitnet_checks=[r["bitnet_checks"] for r in ranks],
        s=round(time.perf_counter() - t_all, 3))
    if bitwise != got.shape[0] or not tf["single_device"]["floor_gate"]:
        raise AssertionError(f"tp path against its references: {tf}")
    need = {"K4": launches["K4"], "K4L": launches["K4L"], "K5": launches["K5"],
            "K2": launches["K2"], "K1": launches["K1"] + bl["K1"], "K3": launches["K3"] + bl["K3"]}
    if not all(need.values()):
        raise AssertionError(f"path 15 launched no call of a kernel: {need}")
    sources = {"K4": "tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped.cu + decode_matmul.cuh",
               "K4L": "tmac_tpu_torch/ops/cuda/csrc/qgemm_grouped_large.cu",
               "K5": "tmac_tpu_torch/ops/cuda/csrc/qgemm_large.cu",
               "K2": "tmac_tpu_torch/ops/cuda/csrc/flash_decode.cu",
               "K1": "tmac_tpu_torch/ops/cuda/csrc/qgemm_fused.cu + decode_matmul.cuh",
               "K3": "tmac_tpu_torch/ops/cuda/csrc/qgemm_large.cu"}
    replaces = {"K4": "tmac_tpu/ops/pallas/qgemm_kernel.py:567",
                "K4L": "tmac_tpu/ops/pallas/qgemm_kernel.py:428",
                "K5": "tmac_tpu/ops/pallas/qgemm_kernel.py:319",
                "K2": "tmac_tpu/ops/pallas/attention_kernel.py:367",
                "K1": "tmac_tpu/ops/pallas/qgemm_kernel.py:567",
                "K3": "tmac_tpu/ops/pallas/qgemm_kernel.py:266"}
    records = []
    for k in ("K4", "K4L", "K5", "K2", "K1", "K3"):
        bit = k in ("K1", "K3")
        t = r0["bitnet_timed" if bit else "timed"][k]
        err = max(r["bitnet_worst" if bit else "worst"][k] for r in ranks)
        records.append(dict(
            name=f"{k} tp=2 shard-local ({'bitnet-3b' if bit else 'llama-2-7b'})",
            path="tp", route="cuda", source=sources[k], replaces=replaces[k],
            launches=need[k], max_abs_err=err, **t))
    return records


# ---------------------------------------------------------------------------
# parallel_paths: sequence, pipeline and expert parallelism as gloo ranks on
# the one card (path 16: sp, sp x tp, pp; path 17: ep, ep x tp, qwen2-moe
# ep, an engine request over ep x tp)
# ---------------------------------------------------------------------------

# depth of every model here (full width; the tp path, path 15, runs 32
# layers); seed; the sp prompt (sp 2: 512 rows a rank, K5) and the chunked
# prefill's spans (256 rows a rank, K4L); the pp prompt and its microbatch
# (K4L); the ep prompt (the dispatch form, K4L on each local expert's
# capacity rows); decode steps
PAR_LAYERS, PAR_SEED = 4, 0
SP_PROMPT, SP_SPAN, SP_STEPS = 1024, 512, 16
PP_PROMPT, PP_MICRO, PP_STEPS = 512, 128, 16
EP_PROMPT, EP_STEPS = 256, 16
# the ep layer check's inputs: layer 0's MoE block at EP_PROMPT rows (the
# dispatch form) and at one (the dense form)
EP_LAYER_FORMS = (("dispatch", EP_PROMPT), ("dense", 1))
PAR_RANK_TIMEOUT_S = 600
# JAX's own gates: tests/test_sp.py and test_pp.py (sp, pp), test_moe.py
# and test_parallel.py (ep, and every tp composition)
SP_RTOL, SP_ATOL, EP_RTOL, EP_ATOL = 3e-2, 3e-2, 5e-2, 0.1


def par_cfg(name):
    from tmac_tpu_torch.models.config import get_preset
    return dataclasses.replace(get_preset(name), num_layers=PAR_LAYERS)


def par_rank(rank, d, world):
    """One rank of parallel_paths (spawned by it): world 2 runs the sp, pp
    and ep jobs, world 4 sp x tp and ep x tp (and the engine request); each
    saves its results to d/rank{rank}.pt."""
    import torch
    from tmac_tpu_torch.parallel import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    launch.init("gloo", "cuda:0", init_method=f"file://{d}/rendezvous", world_size=world,
                rank=rank)
    try:
        with torch.no_grad():
            torch.save(par_rank_run(rank, world), f"{d}/rank{rank}.pt")
    finally:
        launch.shutdown()


def par_timed(fn):
    """fn() with the launch counts zeroed before and read after -> (its
    result, the counts, host seconds to the card's end)."""
    import torch
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def par_rank_run(rank, world):
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.parallel import ep as epmod
    from tmac_tpu_torch.parallel import pp as ppmod
    from tmac_tpu_torch.parallel import sp as spmod
    from tmac_tpu_torch.parallel import tp as tpmod
    card = Card()
    dev = card.dev
    out = {"rank": rank}
    if world == 2:
        # sp 2: a SP_PROMPT-token prefill, then SP_STEPS steps of decode_loop
        # from the sp cache (tp 1: the single-device path reads it); then
        # the same prompt through sp_prefill_chunked (start > 0)
        cfg = par_cfg("llama-2-7b")
        params = params_on_card(cfg, PAR_SEED, dev)
        mesh = spmod.make_sp_mesh(2, device=dev)
        prefill = spmod.make_sp_prefill(cfg, mesh, params)
        prompt = tp_prompt(cfg, SP_PROMPT).to(dev)
        cache = KVCache.create(cfg, 1, SP_PROMPT + SP_STEPS, device=dev)
        (last, cache), launches, s = par_timed(lambda: prefill(prompt, cache))
        first = torch.argmax(last, -1).to(torch.int32)
        toks, _ = loop_decode(prefill.model, first, clone_cache(cache), SP_STEPS)
        c2 = KVCache.create(cfg, 1, SP_PROMPT + SP_STEPS, device=dev)
        (last2, c2), launches2, s2 = par_timed(
            lambda: spmod.sp_prefill_chunked(prefill, prompt, c2, SP_SPAN))
        out["sp"] = dict(last=last.cpu(), k=cache.k.cpu(), v=cache.v.cpu(), toks=toks,
                         launches=launches, prefill_s=s, chunked_last=last2.cpu(),
                         chunked_k=c2.k.cpu(), chunked_launches=launches2, chunked_s=s2)
        del params, prefill, cache, c2
        torch.cuda.empty_cache()

        # pp 2: PP_PROMPT tokens in microbatches of PP_MICRO, PP_STEPS greedy steps
        params = params_on_card(cfg, PAR_SEED, dev)
        mesh = ppmod.make_pp_mesh(2, device=dev)
        tree, specs = ppmod.stack_params_pp(params, 2)
        sparams = ppmod.shard_params_pp(tree, specs, mesh)
        del params, tree
        torch.cuda.empty_cache()
        prefill = ppmod.make_pp_prefill(cfg, mesh, sparams, chunk=PP_MICRO)
        decode = ppmod.make_pp_decode_step(cfg, mesh, sparams)
        cache = ppmod.shard_cache_pp(KVCache.create(cfg, 1, PP_PROMPT + PP_STEPS, device=dev),
                                     mesh)
        prompt = tp_prompt(cfg, PP_PROMPT).to(dev)

        def pp_run():
            lg, c = prefill(prompt, cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, tok = [lg], torch.argmax(lg, -1)
            for _ in range(PP_STEPS):
                lg, c = decode(tok.to(torch.int32), c)
                logits.append(lg)
                tok = torch.argmax(lg, -1)
            torch.cuda.synchronize()
            return torch.cat(logits), c, (time.perf_counter() - t0) * 1e3 / PP_STEPS
        (logits, cache, step_ms), launches, s = par_timed(pp_run)
        out["pp"] = dict(logits=logits.cpu(), k=cache.k.cpu(), launches=launches, s=s,
                         step_ms=step_ms, stage_layers=len(prefill.model.layers))
        del sparams, prefill, decode, cache
        torch.cuda.empty_cache()

        # ep 2: mixtral-8x7b, then qwen2-moe-a14b (its shared expert)
        for name in ("mixtral-8x7b", "qwen2-moe-a14b"):
            mcfg = par_cfg(name)
            params = params_on_card(mcfg, PAR_SEED, dev)
            mesh = epmod.make_moe_mesh(2, 1, device=dev)
            prefill, decode = epmod.make_ep_step(mcfg, mesh, epmod.shard_params_moe(params, mesh))
            del params
            torch.cuda.empty_cache()
            out[name] = ep_rank_job(card, mcfg, prefill, decode)
            out[name]["layer"] = ep_layer_outputs(prefill.model, dev)
            if rank == 0:
                out[name]["checks"] = ep_local_checks(card, mcfg, prefill.model)
            del prefill, decode
            torch.cuda.empty_cache()
    else:
        # sp 2 x tp 2, then ep 2 x tp 2 and one engine request over it
        cfg = par_cfg("llama-2-7b")
        mesh = spmod.make_sp_tp_mesh(2, 2, device=dev)
        params = tpmod.shard_params(tp_params_on_card(cfg, 2, PAR_SEED, dev), mesh)
        torch.cuda.empty_cache()
        prefill = spmod.make_sp_prefill(cfg, mesh, params)
        prompt = tp_prompt(cfg, SP_PROMPT).to(dev)
        cache = KVCache.create(prefill.model.cfg, 1, SP_PROMPT + SP_STEPS, device=dev)
        (last, cache), launches, s = par_timed(lambda: prefill(prompt, cache))
        dec = tpmod.step_fns(prefill.model, tpmod.tp_view(mesh))[1]
        toks, _, step_logits = dec(torch.argmax(last, -1).to(torch.int32), cache, 0, SP_STEPS,
                                   return_logits=True)
        out["sp_tp"] = dict(last=last.cpu(), toks=toks.cpu(), step_logits=step_logits.cpu(),
                            launches=launches, prefill_s=s)
        del params, prefill, cache, dec
        torch.cuda.empty_cache()
        mcfg = par_cfg("mixtral-8x7b")
        mesh = epmod.make_moe_mesh(2, 2, device=dev)
        sparams = epmod.shard_params_moe(tp_params_on_card(mcfg, 2, PAR_SEED, dev), mesh)
        torch.cuda.empty_cache()
        prefill, decode = epmod.make_ep_step(mcfg, mesh, sparams)
        out["ep_tp"] = ep_rank_job(card, mcfg, prefill, decode)
        from tmac_tpu_torch.runtime.engine import InferenceEngine
        eng = InferenceEngine(prefill.model, max_batch=2, max_len=EP_PROMPT + 64, decode_chunk=8,
                              step_fns=epmod.make_moe_engine_fns(mcfg, mesh),
                              cache=KVCache.create(prefill.model.cfg, 2, EP_PROMPT + 64,
                                                   device=dev))
        uid = eng.submit(tp_prompt(mcfg, 100)[0].tolist(), max_new_tokens=16)
        res, launches, s = par_timed(eng.run)
        out["engine"] = dict(tokens=res[uid], launches=launches, s=s)
    return out


def ep_rank_job(card, cfg, prefill, decode):
    """An ep rank's run: EP_PROMPT tokens (the dispatch form), EP_STEPS greedy
    steps (the dense form), their logits, launch counts and seconds."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    prompt = tp_prompt(cfg, EP_PROMPT).to(card.dev)
    cache = KVCache.create(prefill.model.cfg, 1, EP_PROMPT + EP_STEPS, device=card.dev)

    def run():
        last, c = prefill(prompt, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, c, logits = decode(torch.argmax(last, -1).to(torch.int32), c, 0, EP_STEPS,
                                 return_logits=True)
        torch.cuda.synchronize()
        return last, toks, logits, (time.perf_counter() - t0) * 1e3 / EP_STEPS
    (last, toks, logits, step_ms), launches, s = par_timed(run)
    return dict(last=last.cpu(), toks=toks.cpu(), step_logits=logits.cpu(), launches=launches,
                s=s, step_ms=step_ms,
                local_experts=prefill.model.layers[0].experts_gate_up.packed.shape[0])


def ep_layer_input(cfg, rows, dev):
    """The ep layer check's hidden states (1, rows, H) bf16, drawn from
    PAR_SEED + rows on the host: the same in every process."""
    import torch
    g = torch.Generator().manual_seed(PAR_SEED + rows)
    return torch.randn((1, rows, cfg.hidden_size), generator=g).to(torch.bfloat16).to(dev)


def ep_layer_outputs(model, dev):
    """Layer 0's MoE block on this rank, as the forward runs it (moe_mlp on
    the rank's experts, ep_axis the rank's place, then the one sum over the
    ranks), on each of EP_LAYER_FORMS' inputs -> {form: (the rank's bf16
    partial, the sum)}."""
    from tmac_tpu_torch.models.llama import _tp_sum
    from tmac_tpu_torch.models.moe import moe_mlp
    cfg, layer, out = model.cfg, model.layers[0].moe_layer(), {}
    for form, rows in EP_LAYER_FORMS:
        d = moe_mlp(ep_layer_input(cfg, rows, dev), layer, cfg, cfg.quant.mode,
                    act_gs=cfg.quant.act_group_size, ep_axis=model.ep)
        part = d.cpu()
        out[form] = (part, _tp_sum(d, None, model.moe_group).cpu())
    return out


def ep_layer_gate(want, got, parts):
    """One MoE layer's output summed over the ep ranks (got) against the
    single device's moe_mlp on the same input in the same form (want),
    parts the ranks' bf16 partials, all f32 arrays.  The split may add only
    bf16 roundings: each partial's, the sum's, and want's own, half an ulp
    each; so every element within 2 bf16 ulps of the largest of |want|,
    |got| and the partials there, plus 2^-20 of it for the f32 sums'
    order.  -> dict (held, the largest difference in those ulps and
    absolute)."""
    import numpy as np
    m = np.maximum.reduce([np.abs(a) for a in (want, got, *parts)])
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    diff = np.abs(got - want)
    return dict(held=bool((diff <= 2 * ulp + m * 2.0 ** -20).all()),
                max_ulps=float((diff / ulp).max()), max_abs_diff=float(diff.max()),
                largest=float(m.max()))


def ep_local_checks(card, cfg, model):
    """An ep rank's kernels at its shapes, against their plain versions: K4
    (the dense decode form, N = 1) and K4L (the dispatch form's capacity
    rows) on its first local expert's gate_up and down of layer 0, with
    the folds the MoE MLP gives them (none on gate_up: the norm runs
    before; SwiGLU into down where its K is unpadded).  -> (rows, worst
    error by kernel, times by kernel)."""
    from tmac_tpu_torch.models.moe import expert_capacity, expert_view
    blk = model.layers[0]
    gu, dn = (expert_view(getattr(blk, n).qt, 0) for n in ("experts_gate_up", "experts_down"))
    C = expert_capacity(EP_PROMPT, cfg)
    rows, worst, timed = {}, {}, {}
    for kernel, N in (("K4", 1), ("K4L", C)):
        calls = [(f"expert gate_up {gu.kdim}x{gu.mdim}", card.bf16(N, gu.kdim), gu, {})]
        if dn.kdim_padded == dn.kdim:
            calls.append((f"expert down {dn.kdim}x{dn.mdim} glu", card.bf16(N, 2 * dn.kdim),
                          dn, dict(glu=True)))
        else:
            calls.append((f"expert down {dn.kdim}x{dn.mdim}", card.bf16(N, dn.kdim), dn, {}))
        rows[kernel], _ = check_k4(card, calls)
        worst[kernel] = max(r.get("max_abs_err", 0.0) for r in rows[kernel])
        per = [time_k4(card, [(x, qt, kw)], reps=5) for _, x, qt, kw in calls]
        timed[kernel] = {k: sum(p[k] for p in per)
                         for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        timed[kernel]["bound_by"] = dominant_bound(per)
    return dict(rows=rows, worst=worst, timed=timed)


def par_spawn(worlds, timeout=PAR_RANK_TIMEOUT_S):
    """A set of par_rank ranks (torch.multiprocessing, spawn) on the card
    for each world size in `worlds`, the sets at once, each its own group;
    -> {world: its ranks' results} after every rank has ended (a hung rank
    ends the phase at the timeout), and each set's seconds."""
    import tempfile

    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as top:
        t0 = time.perf_counter()
        dirs = {w: tempfile.mkdtemp(dir=top) for w in worlds}
        ctxs = {w: mp.start_processes(par_rank, args=(dirs[w], w), nprocs=w, join=False,
                                      start_method="spawn") for w in worlds}
        seconds = {}
        try:
            for w, ctx in ctxs.items():
                while not ctx.join(timeout=1):
                    if time.perf_counter() > t0 + timeout:
                        raise AssertionError(f"a parallel_paths rank ran past {timeout} s")
                seconds[f"world{w}"] = round(time.perf_counter() - t0, 3)
        finally:
            for ctx in ctxs.values():
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
        return {w: [torch.load(f"{dirs[w]}/rank{r}.pt", weights_only=False) for r in range(w)]
                for w in worlds}, seconds


def sp_one_process(model, prompt, cache, sp, attn_chunk=512, start=0):
    """The sp forward of `sp` ranks computed in one process, rank by rank at
    every layer: each shard's rows through the same kernels at the same
    shapes, the K/V of every shard laid side by side (what the ranks'
    gather gives), the attention and MLP of each shard, then the last
    shard's last row through the head: what the ranks compute, without the
    process group.  -> (last logits, cache)."""
    import torch
    from tmac_tpu_torch.models.llama import _write_kv_stacked, layer_qkv_rope, rms_norm, rope_tables
    from tmac_tpu_torch.parallel import sp as spmod
    cfg = model.cfg
    B, T = prompt.shape
    Tl = T // sp
    lin = model.linear()
    dev = prompt.device
    xs = [model.embed[prompt[:, i * Tl:(i + 1) * Tl]] for i in range(sp)]
    pos = [(start + i * Tl + torch.arange(Tl, device=dev))[None].expand(B, Tl) for i in range(sp)]
    tables = [rope_tables(p, model.freqs, model.table_scale) for p in pos]
    span = (start + torch.arange(T, device=dev))[None].expand(B, T)
    KV, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    for li, blk in enumerate(model.layers):
        qkv = [layer_qkv_rope(blk, cfg, x, t, lin) for x, t in zip(xs, tables)]
        _write_kv_stacked(cache.k, li, torch.cat([k for _, k, _ in qkv], 1), span)
        _write_kv_stacked(cache.v, li, torch.cat([v for _, _, v in qkv], 1), span)
        for i in range(sp):
            attn = spmod.chunked_causal_attention(
                qkv[i][0].reshape(B, Tl, KV, rep, cfg.head_dim), cache.k[li], cache.v[li],
                pos[i], kv_len=start + (i + 1) * Tl, D=cfg.head_dim, chunk=attn_chunk,
                window=cfg.sliding_window).to(xs[i].dtype)
            xs[i] = spmod.layer_out_mlp(blk, cfg, xs[i], attn, lin)
    last = model._head(rms_norm(xs[-1][:, -1:], model.final_norm, cfg.rms_norm_eps))[:, 0]
    cache.pos.fill_(start + T)
    return last.float(), cache


def pp_one_process(cfg, params, prompt, micro, steps, dev):
    """The pp ranks' computation in one process: a stage model over every
    layer (pp.stage_model on a one-rank mesh) through the same microbatches
    (make_pp_prefill) and decode steps (make_pp_decode_step): what the
    stages compute, one after the other.  -> (the prefill's and each greedy
    step's logits (1 + steps, V), cache)."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.parallel import pp as ppmod
    from tmac_tpu_torch.parallel import tp as tpmod
    mesh = tpmod.Mesh(dp=1, tp=1, rank=0, device=dev)
    tree, specs = ppmod.stack_params_pp(params, 1)
    prefill = ppmod.make_pp_prefill(cfg, mesh, tree, chunk=micro)
    decode = ppmod.make_pp_decode_step(cfg, mesh, tree)
    lg, c = prefill(prompt, KVCache.create(cfg, 1, prompt.shape[1] + steps, device=dev))
    logits, tok = [lg], torch.argmax(lg, -1)
    for _ in range(steps):
        lg, c = decode(tok.to(torch.int32), c)
        logits.append(lg)
        tok = torch.argmax(lg, -1)
    return torch.cat(logits), c


@contextlib.contextmanager
def ep_partial_sums(ep):
    """Within it, models/llama.py's moe_mlp runs as `ep` ranks compute it:
    each rank's slice of the stacks (moe_mlp(ep_axis=(i, ep))), the ranks'
    bf16 outputs added in rank order (what the group's sum gives two
    ranks)."""
    from tmac_tpu_torch.models import llama
    from tmac_tpu_torch.models.moe import moe_mlp
    saved = llama.moe_mlp

    def partial_sums(x, layer, cfg, mode=None, act_gs=0, ep_axis=None, **kw):
        out = None
        for i in range(ep):
            mine = dict(layer)
            for n in ("experts_gate_up", "experts_down"):
                qt, E = layer[n], layer[n].packed.shape[0] // ep
                mine[n] = dataclasses.replace(
                    qt, packed=qt.packed[i * E:(i + 1) * E], scales=qt.scales[i * E:(i + 1) * E],
                    sub=qt.sub[i * E:(i + 1) * E],
                    packed_hi=None if qt.packed_hi is None else qt.packed_hi[i * E:(i + 1) * E])
            o = moe_mlp(x, mine, cfg, mode, act_gs=act_gs, ep_axis=(i, ep), **kw)
            out = o if out is None else out + o
        return out
    llama.moe_mlp = partial_sums
    try:
        yield
    finally:
        llama.moe_mlp = saved


@contextlib.contextmanager
def ep_masked_split(ep):
    """Within it, models/llama.py's moe_mlp is the single device's (no
    ep_axis) run ep times, run i on every expert with the scales and zero
    points of all but the i-th E / ep of them zeroed (their outputs exactly
    zero), the shared expert whole in run 0, each in the form ep takes
    (dispatch for prefill blocks of 64 rows or more, else dense), their
    bf16 outputs added in order: the MoE sum split into ep bf16 partials
    as the ranks split it, by a route that does not use ep_axis (ep's
    noise floor)."""
    import torch
    from tmac_tpu_torch.models import llama
    from tmac_tpu_torch.models.moe import moe_mlp
    saved, masked = llama.moe_mlp, {}

    def part(layer, i):
        key = (id(layer["experts_gate_up"].scales), i)
        if key not in masked:
            out = {k: v for k, v in layer.items() if i == 0 or not k.startswith("shared_")}
            for n in ("experts_gate_up", "experts_down"):
                qt = layer[n]
                E = qt.scales.shape[0] // ep
                keep = torch.zeros(qt.scales.shape[0], dtype=torch.bool, device=qt.scales.device)
                keep[i * E:(i + 1) * E] = True

                def zero(t):
                    if t is None:
                        return None
                    return torch.where(keep.reshape(-1, *[1] * (t.dim() - 1)), t,
                                       torch.zeros((), dtype=t.dtype, device=t.device))
                out[n] = dataclasses.replace(qt, scales=zero(qt.scales), sub=zero(qt.sub))
            masked[key] = out
        return masked[key]

    def split(x, layer, cfg, mode=None, act_gs=0, ep_axis=None, **kw):
        B, T, _ = x.shape
        kw["moe_impl"] = "dispatch" if T > 1 and B * T >= 64 else "dense"
        out = None
        for i in range(ep):
            o = moe_mlp(x, part(layer, i), cfg, mode, act_gs=act_gs, **kw)
            out = o if out is None else out + o
        return out
    llama.moe_mlp = split
    try:
        yield
    finally:
        llama.moe_mlp = saved


def forced_logits(model, cfg, prompt, toks, dev, chunk=None):
    """model's last logits of the prompt (in chunks of `chunk` rows), then
    along toks (1, n) a token a step (the first n - 1) -> (n, V) f32."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    cache = KVCache.create(cfg, 1, prompt.shape[1] + toks.shape[1], device=dev)
    T, chunk = prompt.shape[1], chunk or prompt.shape[1]
    for off in range(0, T, chunk):
        lg, cache = model(prompt[:, off:off + chunk], cache)
    out = [lg[:, -1]]
    for i in range(toks.shape[1] - 1):
        lg, cache = model(toks[:, i:i + 1].to(dev), cache)
        out.append(lg[:, -1])
    return torch.cat(out).float()


def eager_step_ms(model, cfg, prompt, steps, dev):
    """The single-device model's eager decode step after `prompt` (a
    prefill, then `steps` greedy steps on the host's clock, the card
    synchronized): ms a step, as the ranks' steps are timed."""
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    cache = KVCache.create(cfg, 1, prompt.shape[1] + steps, device=dev)
    lg, cache = model(prompt, cache)
    tok = torch.argmax(lg[:, -1], -1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = model(tok, cache)
        tok = torch.argmax(lg[:, -1], -1)[:, None]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def single_gate(want, got, floor, rtol, atol):
    """got against the single-device forward's want (P, V): JAX's gate (every
    logit within rtol, atol), or, where random layers carry the rounding of
    the rank split past it, the noise floor: got's mean relative rms
    difference from want at most TP_FLOOR times floor's (another
    single-device forward of the same weights, another route; as path 15's
    tp_gap).  -> dict (held: either; both gates' numbers)."""
    import numpy as np
    diff = np.abs(got - want)
    outside = diff > atol + rtol * np.abs(want)
    rel, rel_floor = float(rel_rms(got, want).mean()), float(rel_rms(floor, want).mean())
    jax = bool(not outside.any())
    floor_gate = rel <= TP_FLOOR * rel_floor
    return dict(held=jax or floor_gate, jax_gate=jax, floor_gate=floor_gate,
                share_outside=float(outside.mean()), max_abs_diff=float(diff.max()),
                mean_rel_rms=rel, floor_mean_rel_rms=rel_floor,
                argmax_agreement=float((got.argmax(-1) == want.argmax(-1)).mean()),
                rtol=rtol, atol=atol, floor_factor=TP_FLOOR)


def parallel_paths(card):
    """The phase parallel_paths: gloo ranks on the one card, every model at
    full width and PAR_LAYERS layers, weights drawn on the card from
    PAR_SEED (each rank draws the same tree).  Path 16: llama-2-7b W2 g128
    at sp 2 (a SP_PROMPT-token prompt, K5 at 512 rows a rank; then the same
    prompt through sp_prefill_chunked in spans of SP_SPAN: start > 0, K4L;
    SP_STEPS steps of decode_loop from the sp cache), at sp 2 x tp 2 (the tp
    decode path reading the sp cache), at pp 2 (PP_PROMPT tokens in
    microbatches of PP_MICRO, PP_STEPS greedy steps through the stages).
    Path 17: mixtral-8x7b W2 at ep 2 and ep 2 x tp 2, qwen2-moe-a14b W2 at
    ep 2 (its gated shared expert, divided by the ep size), EP_PROMPT tokens
    (dispatch: K4L) and EP_STEPS greedy steps (dense: K4, never K7), an
    engine request over ep 2 x tp 2 (make_moe_engine_fns).  Held, in this
    process on the same weights: sp 2 bit for bit to sp_one_process (logits
    and cache, both spans' runs) and its decode_loop tokens to the one
    process cache's; pp 2 bit for bit to pp_one_process at every step; ep 2
    bit for bit to the single-device forward with ep_partial_sums,
    teacher-forced along the ranks' tokens, and layer 0's MoE block summed
    over the ranks (both forms) to the single device's moe_mlp on the same
    input by ep_layer_gate (2 bf16 ulps); each against the single-device
    forward (teacher-forced, its prefill at the ranks' rows) by
    single_gate: JAX's tests' tolerance, or a noise floor (sp: the single
    device at 256-row chunks, K4L; pp: in one chunk, K5; ep: the single
    device's MoE sums split into two bf16 partials by masked experts,
    ep_masked_split, no ep_axis); sp x tp and ep x tp by path 15's tp_gap
    (the floor: the weights unsharded); JAX's gate reported for all.  The two
    sets of ranks run at once.  Each rank's kernel
    launches are read around its run.  -> the kernels line's records."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.llama import KVCache, Llama
    t_all = time.perf_counter()
    sets, ranks_s = par_spawn((2, 4))
    two, four = sets[2], sets[4]
    r0, q0 = two[0], four[0]
    dev, out, fail = card.dev, {}, []
    cfg = par_cfg("llama-2-7b")
    with torch.no_grad():
        params = params_on_card(cfg, PAR_SEED, dev)
        single = Llama(cfg, params)
        # sp 2
        prompt = tp_prompt(cfg, SP_PROMPT).to(dev)
        ref_last, ref_cache = sp_one_process(
            single, prompt, KVCache.create(cfg, 1, SP_PROMPT + SP_STEPS, device=dev), 2)
        ref_toks, _ = loop_decode(single, torch.argmax(ref_last, -1).to(torch.int32),
                                  clone_cache(ref_cache), SP_STEPS)
        c2 = KVCache.create(cfg, 1, SP_PROMPT + SP_STEPS, device=dev)
        for off in range(0, SP_PROMPT, SP_SPAN):
            ref2, c2 = sp_one_process(single, prompt[:, off:off + SP_SPAN], c2, 2, start=off)
        sp = r0["sp"]
        toks = torch.tensor([[int(torch.argmax(sp["last"], -1))] + sp["toks"][:-1]])
        want = forced_logits(single, cfg, prompt, toks, dev, chunk=SP_PROMPT // 2).cpu().numpy()
        # the noise floor: the single device at 256-row chunks (K4L, not K5)
        floor = forced_logits(single, cfg, prompt, toks, dev, chunk=SP_SPAN // 2).cpu().numpy()
        got_first = sp["last"].numpy()
        out["sp"] = dict(
            bitwise_last=bool(torch.equal(sp["last"], ref_last.cpu())),
            bitwise_cache=bool(torch.equal(sp["k"], ref_cache.k.cpu()) and
                               torch.equal(sp["v"], ref_cache.v.cpu())),
            bitwise_chunked_last=bool(torch.equal(sp["chunked_last"], ref2.cpu())),
            bitwise_chunked_cache=bool(torch.equal(sp["chunked_k"], c2.k.cpu())),
            decode_tokens_equal=sp["toks"] == ref_toks,
            single_device=single_gate(want[:1], got_first, floor[:1], SP_RTOL, SP_ATOL),
            launches=sp["launches"], chunked_launches=sp["chunked_launches"],
            prefill_s=[r["sp"]["prefill_s"] for r in two],
            chunked_s=[r["sp"]["chunked_s"] for r in two])
        del ref_cache, c2
        # single-device prefill time at the same prompt (K5 at 1024 rows)
        cache = KVCache.create(cfg, 1, SP_PROMPT, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single(prompt, cache)
        torch.cuda.synchronize()
        out["sp"]["single_device_prefill_s"] = time.perf_counter() - t0
        del cache
        s = out["sp"]
        if not (s["bitwise_last"] and s["bitwise_cache"] and s["bitwise_chunked_last"]
                and s["bitwise_chunked_cache"] and s["decode_tokens_equal"]
                and s["single_device"]["held"]):
            fail.append("sp")

        # pp 2
        prompt = tp_prompt(cfg, PP_PROMPT).to(dev)
        ref_logits, ref_c = pp_one_process(cfg, params, prompt, PP_MICRO, PP_STEPS, dev)
        pp = r0["pp"]
        ks = torch.cat([r["pp"]["k"] for r in two])
        toks = pp["logits"].argmax(-1)[None]
        want = forced_logits(single, cfg, prompt, toks, dev, chunk=PP_MICRO).cpu().numpy()
        # the noise floor: the single device's prefill in one chunk (K5)
        floor = forced_logits(single, cfg, prompt, toks, dev).cpu().numpy()
        pp_single_ms = eager_step_ms(single, cfg, prompt, PP_STEPS, dev)
        out["pp"] = dict(bitwise_logits=bool(torch.equal(pp["logits"], ref_logits.cpu())),
                         step_ms=[r["pp"]["step_ms"] for r in two],
                         single_device_step_ms=pp_single_ms,
                         bitwise_cache=bool(torch.equal(ks, ref_c.k.cpu())),
                         stage_layers=pp["stage_layers"],
                         single_device=single_gate(want, pp["logits"].numpy(), floor, SP_RTOL,
                                                   SP_ATOL),
                         launches={k: sum(r["pp"]["launches"][k] for r in two) for k in COUNTERS},
                         s=[r["pp"]["s"] for r in two])
        p_ = out["pp"]
        if not (p_["bitwise_logits"] and p_["bitwise_cache"] and p_["single_device"]["held"]):
            fail.append("pp")
        del ref_c

        # sp 2 x tp 2 against the single device over the tp-packed weights
        # (wo, down on the XLA route) and the noise floor (unsharded)
        tparams = tp_params_on_card(cfg, 2, PAR_SEED, dev)
        st = q0["sp_tp"]
        prompt = tp_prompt(cfg, SP_PROMPT).to(dev)
        toks = torch.cat([st["last"].argmax(-1)[:, None], st["toks"]], 1)
        want = forced_logits(Llama(cfg, tparams), cfg, prompt, toks, dev, SP_PROMPT // 2)
        floor = forced_logits(Llama(cfg, unsharded_tree(tparams)), cfg, prompt, toks, dev,
                              SP_PROMPT // 2)
        got = torch.cat([st["last"], st["step_logits"][0]]).numpy()
        gap = tp_gap(want.cpu().numpy(), got, floor.cpu().numpy(), toks[0].numpy(), 1)
        out["sp_tp"] = dict(single_device=gap, launches={k: sum(r["sp_tp"]["launches"][k]
                                                               for r in four)
                                                        for k in COUNTERS},
                            prefill_s=[r["sp_tp"]["prefill_s"] for r in four])
        if not gap["floor_gate"]:
            fail.append("sp_tp")
        del tparams, params, single
        torch.cuda.empty_cache()

        # ep 2: mixtral-8x7b and qwen2-moe-a14b, bit for bit to the partial
        # sums in one process, layer 0's MoE block against the single
        # device's, and the logits against the single device
        from tmac_tpu_torch.models.moe import moe_mlp
        records_ep = {}
        for name in ("mixtral-8x7b", "qwen2-moe-a14b"):
            mcfg = par_cfg(name)
            mparams = params_on_card(mcfg, PAR_SEED, dev)
            e = r0[name]
            prompt = tp_prompt(mcfg, EP_PROMPT).to(dev)
            toks = torch.cat([e["last"].argmax(-1)[:, None], e["toks"]], 1)
            got = torch.cat([e["last"], e["step_logits"][0]]).numpy()
            model = Llama(mcfg, mparams)
            layer = {}
            for form, rows in EP_LAYER_FORMS:
                want1 = moe_mlp(ep_layer_input(mcfg, rows, dev), model.layers[0].moe_layer(),
                                mcfg, mcfg.quant.mode, act_gs=mcfg.quant.act_group_size,
                                moe_impl=form)
                sums = [r[name]["layer"][form][1] for r in two]
                layer[form] = dict(
                    ep_layer_gate(want1.float().cpu().numpy(), sums[0].float().numpy(),
                                  [r[name]["layer"][form][0].float().numpy() for r in two]),
                    ranks_equal=all(torch.equal(t, sums[0]) for t in sums))
            with ep_partial_sums(2):
                exact = forced_logits(model, mcfg, prompt, toks, dev).cpu().numpy()
            want = forced_logits(model, mcfg, prompt, toks, dev).cpu().numpy()
            # the noise floor: the single device's MoE sums split into the
            # ranks' two bf16 partials by masked experts (ep_masked_split)
            with ep_masked_split(2):
                floor = forced_logits(model, mcfg, prompt, toks, dev).cpu().numpy()
            rec = dict(bitwise=bool(np.array_equal(exact, got)),
                       floor_equal=bool(np.array_equal(floor, got)), layer=layer,
                       local_experts=e["local_experts"],
                       step_ms=[r[name]["step_ms"] for r in two],
                       single_device_step_ms=eager_step_ms(model, mcfg, prompt, EP_STEPS, dev),
                       single_device=single_gate(want, got, floor, EP_RTOL, EP_ATOL),
                       launches={k: sum(r[name]["launches"][k] for r in two) for k in COUNTERS},
                       s=[r[name]["s"] for r in two], checks=e["checks"]["rows"])
            out[name] = rec
            records_ep[name] = e["checks"]
            if not (rec["bitwise"] and rec["single_device"]["held"]
                    and all(g["held"] and g["ranks_equal"] for g in layer.values())):
                fail.append(name)
            del mparams, model
            torch.cuda.empty_cache()

        # ep 2 x tp 2
        mcfg = par_cfg("mixtral-8x7b")
        tparams = tp_params_on_card(mcfg, 2, PAR_SEED, dev)
        e = q0["ep_tp"]
        prompt = tp_prompt(mcfg, EP_PROMPT).to(dev)
        toks = torch.cat([e["last"].argmax(-1)[:, None], e["toks"]], 1)
        want = forced_logits(Llama(mcfg, tparams), mcfg, prompt, toks, dev)
        floor = forced_logits(Llama(mcfg, unsharded_tree(tparams)), mcfg, prompt, toks, dev)
        got = torch.cat([e["last"], e["step_logits"][0]]).numpy()
        gap = tp_gap(want.cpu().numpy(), got, floor.cpu().numpy(), toks[0].numpy(), 1)
        eng = q0["engine"]
        out["ep_tp"] = dict(single_device=gap, step_ms=[r["ep_tp"]["step_ms"] for r in four],
                            launches={k: sum(r["ep_tp"]["launches"][k] for r in four)
                                      for k in COUNTERS},
                            s=[r["ep_tp"]["s"] for r in four],
                            engine=dict(tokens=eng["tokens"], s=eng["s"],
                                        launches={k: sum(r["engine"]["launches"][k]
                                                         for r in four) for k in COUNTERS}))
        if not (gap["floor_gate"] and len(eng["tokens"]) == 16
                and all(0 <= t < mcfg.vocab_size for t in eng["tokens"])):
            fail.append("ep_tp")
        del tparams
        torch.cuda.empty_cache()
    finite = all(bool(torch.isfinite(t).all()) for t in (
        r0["sp"]["last"], r0["pp"]["logits"], q0["sp_tp"]["step_logits"],
        q0["ep_tp"]["step_logits"], r0["mixtral-8x7b"]["step_logits"],
        r0["qwen2-moe-a14b"]["step_logits"]))
    say("parallel_paths", card=card.name, nvidia_smi=card.smi, layers=PAR_LAYERS, backend="gloo",
        results=out, finite=finite, ranks_s=ranks_s,
        s=round(time.perf_counter() - t_all, 3))
    if fail or not finite:
        raise AssertionError(f"parallel paths against their references: {fail}")
    need = {"sp K5": out["sp"]["launches"]["K5"], "sp K4L": out["sp"]["chunked_launches"]["K4L"],
            "pp K4L": out["pp"]["launches"]["K4L"], "pp K4": out["pp"]["launches"]["K4"],
            "ep K4L": out["mixtral-8x7b"]["launches"]["K4L"],
            "ep K4": out["mixtral-8x7b"]["launches"]["K4"],
            "qwen ep K4": out["qwen2-moe-a14b"]["launches"]["K4"],
            "ep_tp K4": out["ep_tp"]["launches"]["K4"]}
    if not all(need.values()) or out["mixtral-8x7b"]["launches"]["K7"]:
        raise AssertionError(f"parallel paths' launches: {need}, "
                             f"K7 {out['mixtral-8x7b']['launches']['K7']}")
    records = []
    for kernel, label in (("K4", "the dense decode form, N = 1"),
                          ("K4L", "the dispatch form's capacity rows")):
        t = records_ep["mixtral-8x7b"]["timed"][kernel]
        records.append(dict(
            name=f"{kernel} ep=2 local expert ({label}, mixtral-8x7b)", path="ep",
            route="cuda", source="tmac_tpu_torch/ops/cuda/csrc/" + (
                "qgemm_grouped.cu + decode_matmul.cuh" if kernel == "K4"
                else "qgemm_grouped_large.cu"),
            replaces="tmac_tpu/ops/pallas/qgemm_kernel.py:" + ("567" if kernel == "K4" else "428"),
            launches=sum(out[n]["launches"][kernel] for n in ("mixtral-8x7b", "qwen2-moe-a14b"))
            + out["ep_tp"]["launches"][kernel],
            max_abs_err=max(records_ep[n]["worst"][kernel] for n in records_ep), **t))
    return records


# the full run's timing sweeps start only while the run has spent less
# than SWEEPS_BY_S of its 1200 s (on an NVIDIA H100 80GB HBM3 at 700 W the
# paths took 960-1065 s by host, PERF.md §4; the sweeps need ~150 s)
SWEEPS_BY_S = 900


def full_run_sweeps(card, t_all):
    """The full run's sweeps after its paths (t_all: when they began):
    k4l_k5_sweep_b13 (K4L and K5 at bits 3 and 1, checked), then, where
    the run has spent less than SWEEPS_BY_S, the timing sweeps of kernels
    the paths checked (attn_sweep, qgemm_decode_sweep, pdl_overlap,
    expert_block_sweep, k3_sweep); each one's seconds printed last
    (sweeps_s, with skipped_at_s where the timing sweeps were left out)."""
    sweeps = (
        ("attn_sweep", lambda: say("attn_sweep", card=card.name, nvidia_smi=card.smi,
                                   rows=attn_sweep(card))),
        ("qgemm_decode_sweep", lambda: say("qgemm_decode_sweep", card=card.name,
                                           nvidia_smi=card.smi, rows=qgemm_decode_sweep(card))),
        ("pdl_overlap", lambda: say("pdl_overlap", card=card.name, **pdl_overlap(card))),
        ("expert_block_sweep", lambda: say("expert_block_sweep", **expert_block_sweep(card))),
        ("k3_sweep", lambda: say("k3_sweep", card=card.name, nvidia_smi=card.smi,
                                 rows=k3_sweep(card))))
    seconds, t0 = {}, time.perf_counter()
    sweep_b13_large(card)
    seconds["k4l_k5_sweep_b13"] = round(time.perf_counter() - t0, 3)
    spent = time.perf_counter() - t_all
    if spent >= SWEEPS_BY_S:
        seconds["skipped_at_s"] = round(spent, 3)
        sweeps = ()
    for name, run in sweeps:
        t0 = time.perf_counter()
        run()
        seconds[name] = round(time.perf_counter() - t0, 3)
    say("sweeps_s", **seconds)


def template_args(mangled):
    """A kernel's template arguments from its mangled name: bf16, f32,
    int8, an int or a bool (0, 1) (a substitution, S<n>_, repeats the type
    before it)."""
    rest, args = mangled.partition("_kernelI")[2], []
    while m := re.match(r"13__nv_bfloat16|f|a|L[ib](\d+)E|S\d*_", rest):
        if m.group(0).startswith("S"):
            args.append(args[-1] if args else "?")
        else:
            args.append(m.group(1) or dict(f="f32", a="int8").get(m.group(0), "bf16"))
        rest = rest[m.end():]
    return args


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from tmac_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = Card()
    print(card.smi or "nvidia-smi: no output", flush=True)
    say("device", name=card.name, nvidia_smi=card.smi, torch=torch.__version__,
        cuda=torch.version.cuda,
        count=torch.cuda.device_count(), peak_bytes_per_s=card.bw,
        peak_int8_ops=card.int8_peak, peak_bf16_flops=card.bf16_peak)

    # the kernels build (nvcc, every source at once) on a thread while the
    # full run draws BitNet-3B's weights on the host; finish_build() waits
    built = {}

    def run_build():
        t0 = time.perf_counter()
        try:
            built["logs"] = build.build()
        except Exception as err:  # noqa: BLE001  (raised again by finish_build)
            built["error"] = err
        built["s"] = time.perf_counter() - t0
    builder = threading.Thread(target=run_build, daemon=True)
    builder.start()

    def finish_build():
        """-> (nvcc seconds, ptxas's report per kernel: registers, shared
        memory, spills), once the build has ended; its failure raised."""
        builder.join()
        if "error" in built:
            raise built["error"]
        ptxas, kernel = [], "?"
        for ln in "\n".join(built["logs"].values()).splitlines():
            if "Compiling entry function" in ln:
                mangled = ln.split("'")[1]
                base = re.search(r"(act_quant_grouped|act_quant|expert_quant_token"
                                 r"|expert_quant|qgemm|decode_attention|k1_decode|k4_decode"
                                 r"|k7_decode|k7_token|k3_wgmma|act_bf16|dequant_wgmma|k4_native"
                                 r"|group_mma|block)_kernel", mangled)
                targs = template_args(mangled)
                kernel = f"{base.group(0) if base else mangled}<{','.join(targs)}>"
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
        return built["s"], ptxas

    if sys.argv[1:]:
        build_s, ptxas = finish_build()

    if sys.argv[1:] == ["--phase", "decode_plan_sweep"]:
        say("decode_plan_sweep", card=card.name, nvidia_smi=card.smi,
            rows=decode_plan_sweep(card))
        return 0
    if sys.argv[1:] == ["--phase", "expert_block_sweep"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        say("expert_block_sweep", **expert_block_sweep(card))
        return 0
    if sys.argv[1:] == ["--phase", "k3_sweep"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        say("k3_sweep", card=card.name, nvidia_smi=card.smi, rows=k3_sweep(card))
        return 0
    if sys.argv[1:] == ["--phase", "graph_spread"]:
        say("build", nvcc_s=round(build_s, 3))
        say("graph_spread", card=card.name, nvidia_smi=card.smi, **graph_spread(card))
        return 0
    if sys.argv[1:] == ["--phase", "grouped_paths"]:
        from tmac_tpu_torch.models.config import get_preset
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        records = grouped_path(card, "llama31", get_preset("llama-3.1-8b", bits=3),
                               W3_PROMPT, W3_CHUNK)
        torch.cuda.empty_cache()
        records += grouped_path(card, "qwen2", get_preset("qwen2-7b"), QWEN_PROMPT,
                                QWEN_PROMPT)
        torch.cuda.empty_cache()
        sweep_b13_large(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "ags_path"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        say("k4_ags_check", checks=k4_ags_bits_check(card)[0])
        records = ags_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "engine_serve"]:
        from tmac_tpu_torch.models.config import get_preset
        say("build", nvcc_s=round(build_s, 3))
        cfg = get_preset("qwen2-7b")
        params = params_on_card(cfg, 0, card.dev)
        records = engine_serve(card, cfg, params, llama_in_mode(cfg, params, "explicit"))
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "speculative"]:
        say("build", nvcc_s=round(build_s, 3))
        records = speculative_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "wa8_path"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        records = mixtral_wa8_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "per_channel_path"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        records = per_channel_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "gguf_path"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        records = gguf_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "gguf_lowbit_path"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas,
            nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()})
        records = gguf_lowbit_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "tools_path"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas,
            nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()})
        records = tools_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "lut_forms"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas,
            nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()})
        records = lut_forms(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "attn_forms"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas,
            nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()})
        records = attn_forms(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "parallel_paths"]:
        say("build", nvcc_s=round(build_s, 3),
            nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()})
        records = parallel_paths(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "tp_path"]:
        say("build", nvcc_s=round(build_s, 3),
            nvcc_s_by_source={k: round(v, 3) for k, v in build.build_seconds.items()})
        records = tp_path(card)
        print(json.dumps({"kernels": records}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "qgemm_decode_sweep"]:
        say("build", nvcc_s=round(build_s, 3), ptxas=ptxas)
        say("qgemm_decode_sweep", card=card.name, nvidia_smi=card.smi,
            rows=qgemm_decode_sweep(card))
        say("pdl_overlap", card=card.name, **pdl_overlap(card))
        return 0
    t_all = time.perf_counter()
    records = bitnet_path(card, finish_build)
    records += speculative_path(card)
    records += llama_path(card)
    torch.cuda.empty_cache()
    records += mixtral_path(card)
    torch.cuda.empty_cache()
    records += phi3_path(card)
    torch.cuda.empty_cache()
    from tmac_tpu_torch.models.config import get_preset
    records += grouped_path(card, "llama31", dataclasses.replace(
        get_preset("llama-3.1-8b", bits=3), num_layers=W3_LAYERS), W3_PROMPT, W3_CHUNK)
    torch.cuda.empty_cache()
    records += grouped_path(card, "qwen2", get_preset("qwen2-7b"), QWEN_PROMPT, QWEN_PROMPT,
                            serve=engine_serve)
    torch.cuda.empty_cache()
    k4_ags_rows, _ = k4_ags_bits_check(card)
    say("k4_ags_check", checks=k4_ags_rows)
    records += ags_path(card)
    torch.cuda.empty_cache()
    records += mixtral_wa8_path(card)
    torch.cuda.empty_cache()
    records += gguf_path(card, GGUF_FULL_RUN_LAYERS)
    torch.cuda.empty_cache()
    records += per_channel_path(card)
    torch.cuda.empty_cache()
    records += gguf_lowbit_path(card, LB_FULL_RUN_FORCED, LB_FULL_RUN_Q2K_LAYERS,
                                LB_FULL_RUN_Q8_LAYERS)
    torch.cuda.empty_cache()
    t_tools = time.perf_counter()
    records += tools_path(card)
    say("tools_path_s", s=round(time.perf_counter() - t_tools, 3))
    t_lut = time.perf_counter()
    records += lut_forms(card)
    torch.cuda.empty_cache()
    t_tp = time.perf_counter()
    records += tp_path(card)
    torch.cuda.empty_cache()
    say("lut_tp_s", lut_forms=round(t_tp - t_lut, 3), tp_path=round(time.perf_counter() - t_tp, 3))
    t_new = time.perf_counter()
    records += attn_forms(card)
    torch.cuda.empty_cache()
    t_par = time.perf_counter()
    records += parallel_paths(card)
    torch.cuda.empty_cache()
    say("attn_parallel_s", attn_forms=round(t_par - t_new, 3),
        parallel_paths=round(time.perf_counter() - t_par, 3))
    full_run_sweeps(card, t_all)
    say("record", unit="device ms per decode step of each path (bitnet-3b: "
        "105 K1 and 26 K2 launches, in the block mode 26 K10, 27 K1 and 26 "
        f"K2; llama-2-7b: 128 K4, 1 K1 and 32 K2; mixtral-8x7b ({MIXTRAL_LAYERS} layers): "
        f"{2 * MIXTRAL_LAYERS} "
        "K7 (one call for the 2 routed experts' gate_up, one for their down, a "
        f"layer), {2 * MIXTRAL_LAYERS} K4, {MIXTRAL_LAYERS} K2 and 1 K1; phi-3-mini "
        f"({PHI3_LAYERS} layers): {4 * PHI3_LAYERS} K4, 1 K1 and {PHI3_LAYERS} K6, K8 "
        "or K9; "
        f"llama-3.1-8b W3 ({W3_LAYERS} layers): {4 * W3_LAYERS} K4, 1 K1 and {W3_LAYERS} K2; "
        "qwen2-7b W4: 112 K4, 1 K1 "
        f"and 28 K2; llama-2-7b ags 32 ({AGS_LAYERS} layers): {4 * AGS_LAYERS} K4 (the ags "
        f"form), 1 K1 and {AGS_LAYERS} K2; "
        "mixtral-8x7b w_a8: 64 "
        "K7 (the per-tensor branch), 65 K1 and 32 K2; qwen2-7b's engine, 8 slots: 112 K4, "
        "1 K1 and 28 K2 (K6 on the int8 cache)), "
        "except K3, K5 and K4L: device ms per prefill (bitnet-3b: 420 K3 "
        "launches for 1024 tokens in chunks of 256; llama-2-7b: 256 K5 for "
        f"1024 tokens in chunks of 512; phi-3-mini: {36 * PHI3_LAYERS} K4L for 2304 tokens "
        f"in chunks of 256; llama-3.1-8b: {4 * W3_LAYERS} K5 and {4 * W3_LAYERS} K4L for 768 "
        "tokens in chunks of 512 and 256; qwen2-7b: 112 K4L for 256 tokens; llama-2-7b ags "
        f"32: {4 * AGS_LAYERS} K5 and {4 * AGS_LAYERS} K4L (the ags form) for 768 tokens in "
        "chunks of 512 and 256; mixtral-8x7b "
        "w_a8: 577 K3 for 256 tokens; llama-3.1-8b-q4_k (path 11, f32 grouped scales, "
        f"{GGUF_FULL_RUN_LAYERS} layers): {4 * GGUF_FULL_RUN_LAYERS} K5 and "
        f"{4 * GGUF_FULL_RUN_LAYERS} K4L for 600 tokens in chunks of 512 and 88, "
        f"{4 * GGUF_FULL_RUN_LAYERS} K4, 1 K1 "
        f"and {GGUF_FULL_RUN_LAYERS} K2 a step; mixtral-8x7b-q4_k at 2 layers: 4 K7, 4 K4, 2 "
        "K2 and 1 K1 a step; "
        "llama-3.1-8b w4a8 per channel (path 12): 258 K3 for 1024 tokens in chunks of "
        "512, 129 K1 and 32 K2 a step; llama-3.1-8b-q2_k (path 13, gs 16, "
        f"{LB_FULL_RUN_Q2K_LAYERS} layers): {8 * LB_FULL_RUN_Q2K_LAYERS} "
        "K5 for 600 tokens in chunks of 512 and 88 (each timed at its own rows), "
        f"{4 * LB_FULL_RUN_Q2K_LAYERS} K4, 1 K1 "
        f"and {LB_FULL_RUN_Q2K_LAYERS} K2 a step; llama-3.1-8b-q8_0 "
        f"(path 14, bits 8, {LB_FULL_RUN_Q8_LAYERS} layers): {4 * LB_FULL_RUN_Q8_LAYERS} K5 "
        f"and {4 * LB_FULL_RUN_Q8_LAYERS} K4L for 600 tokens, {4 * LB_FULL_RUN_Q8_LAYERS} K4, "
        f"1 K1 and {LB_FULL_RUN_Q8_LAYERS} K2 a step; mixtral-8x7b-q2_k at 2 layers (path "
        "14b): 4 K5 and 32 K4 for 64 "
        "tokens, 4 K7, 4 K4, 2 K2 and 1 K1 a step; the form checks' records (K4L at gs 16, "
        "K4 and K4L at ags 16): ms over one layer's four linears, launches over the "
        "checks; the tools' E1-E4 (tools_path): ms over the timed calls, launches over the "
        "tools' run, whose timed chains keep their fixed lengths); "
        "launches: the wrappers' counts over each path's "
        "prefill and decode_loop, which calls a step's wrappers twice (its "
        "eager first step and the one capture) and replays the graph for "
        "the other 63 steps without the host (launched_on_card in step_ms: "
        "prefill + 64 steps) (bitnet-3b K3, K10: the block-mode run; "
        "phi-3-mini K8, K9: decode only); step_ms per path: eager (a loop of "
        "decode_step), graph (chip_smoke's captured step), loop (decode_loop's "
        "replayed step, the median of three runs, with min, median and max)",
        card=card.name,
        nvidia_smi=card.smi,
        step_ms=STEP_MS, paths_s=round(time.perf_counter() - t_all, 3))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
