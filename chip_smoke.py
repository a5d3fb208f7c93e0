#!/usr/bin/env python3
"""Drive the PyTorch port (onnx_rusty_inference_engine_tpu_torch) on one
NVIDIA H100 and check what comes out.

    python3 chip_smoke.py      # from the root of a checkout, one CUDA card

Phases, each printing JSON lines:

1. device  - the card (name and power limit as nvidia-smi prints them);
             TF32 is off for every comparison (cudnn and matmul flags,
             scoped to this script's run).
2. build   - compiles every kernel source in csrc/ with nvcc for sm_90a,
             one nvcc per source, all at once; ptxas's registers, shared
             memory and spills for each kernel entry; beside them the
             native C++ ONNX parser (g++, native_loader), which
             import_onnx takes from here on (the CLI's children too).
3. slice   - SqueezeNet: the port's entry points at 224x224 (random weights
             from seed 0); golden check at b1 against
             tests/goldens/squeezenet.pb; fp32 Engine at b256; calibrate on
             x[:8]; quantize_graph; INT8 Engine at b256. Every kernel's
             launch count is set to 0 just before and read just after;
             every QLinearConv must launch the int8 kernel (26 per INT8
             forward: 17 on its TMA producer, conv1 (as its space-to-depth
             rewrite, the `s2d` form, one a forward) and fires 2-5's
             expands on its staged-halo producer, fires 6-9's expands on
             its gather: SQUEEZENET_PRODUCERS). The
             card's
             INT8 intermediates are held against the plain versions run on
             the CPU for the first 4 images; which 4-D intermediates are
             channels-last on the card, by op type. fp32 and INT8 images/s
             from CUDA events over warmed, device-resident runs.
4. profile - where one fp32 and one INT8 forward spend device time, by
             kernel, from torch.profiler (device busy share of the wall
             time under the profiler), the copy kernels left per forward,
             and a second profiled forward with the Engine's own node
             ranges (`<OpType>.<node>`): device ms by op type, the hand
             kernels' inside them (each launch lies under its `oriet::`
             op, and so under its node's range), and each `oriet::` op's
             own device ms.
5. kernel  - one line per distinct QLinearConv shape of that run: the
             kernel against its plain version on the same (real) inputs on
             the card, bit for bit; kernel and library (torch._int_mm, 1x1
             convs) times from a replayed CUDA graph on the input laid out
             channels-last, as the previous conv leaves it; the layout copy
             the wrapper still makes on the main path's input (conv1's
             NCHW, 3 channels padded to 4), timed alone; plain time; the
             card's bound; TOP/s and GB/s.
6. decode  - GPT-2 124M (the SMALL config: 12 layers, 12 heads of 64, n_embd
             768, vocab 50257; random weights from seed 0) through
             Generator.generate with INT4 planar weights, an INT8 KV cache
             and fused attention: batch 8, 64-token prompts, max_len 256, 64
             new greedy tokens. Counts set to 0 just before, read just
             after: 49 int4 launches per prefill and per decode step (4 per
             layer + the lm_head), every prefill launch on the int4
             kernel's mma schedule and every step launch on small_m, 12
             attention launches per step. The
             prefill and the first 4 steps are re-run through the plain
             versions on the CPU with the card's tokens and KV scales:
             logits within 1e-2 * max|logit|, greedy agreement reported.
             Then the same path with ORIET_ATTN_I8=1 (the int8 x int8
             attention kernel, its own counts). Then decode tokens/s (wall
             and CUDA events) for fp32 weights + fp32 KV, INT4 + INT8 KV
             unfused, fused, and fused int8 x int8: for information only.
7. profile - one decode step of the fused INT4 path under torch.profiler:
             device busy against wall time, the idle share, by kernel.
8. kernel  - one line per distinct int4 and attention shape of the decode
             path (int4: with its schedule and the wrapper's host time per
             call), on the card against the plain version (int4 and f32
             attention within 1e-5 * max|out|, int8 x int8 attention within
             1e-2 * max|out|), with the kernel, plain and library times and
             the card's bound; then the nibble-unpack probe, every unpack
             variant the int4 schedules use, bit for bit.
             Kernel and library times are device times from a replayed
             CUDA graph of DEC_ITERS calls (ms_eager: the same calls issued
             from Python, host time included); plain times are eager. The
             attention lines also give the kernel's cluster size, the K/V
             rows it loaded (counted by the kernel, held equal to
             attn_live_chunks), the bytes it moved (bytes_read) beside the
             bytes of the bound, and times with the cache cold in L2.
8b. attn_sweep - both attention kernels at six shapes (GPT-2's step at
             L 256 with 65 and 128 valid rows, L 1024 all valid at batch 8
             and 1, L 1024 with 257 valid, GQA 32/8 heads of 128 at L
             1024), each held to its plain version on the card (1e-5 and
             1e-2 x max|out|), timed hot and cold beside SDPA bf16, with
             its bound, cluster size, rows and bytes read.
9. bert    - BERT-base (30522 vocab, 12 layers, 12 heads of 64, hidden
             768; random weights from seed 0) at B = 32, T = 128, with an
             attention mask that pads each sequence after a random length
             in 32-128: fp32 Engine; calibrate on the first 8 sequences (a
             B = 8 build of the same seed: the graph bakes B into its
             Reshape constants); quantize_graph; INT8 Engine. Counts set to
             0 just before, read just after: 73 qmatmul_int8 launches per
             INT8 forward (6 per layer + the pooler), all on its requant
             epilogue, and no other kernel.
             The first 4 sequences re-run through the plain versions on the
             CPU (a B = 4 build, quantized with the card's ranges): fp32
             outputs within 1e-4 * max|out|; every QLinearMatMul, fed the
             card's own int8 input, equal to the card's output bit for bit;
             the INT8 outputs' mean |INT8 - fp32| on the card within 1.25x
             the plain version's. Run free, the two devices' int8 values
             part layer by layer (a requant tie that an fp32 island's
             summation order moves one step cascades through the int8
             q/k/v): their equal fractions are printed, not held. fp32 and
             INT8 sequences/s from CUDA events.
10. profile - one fp32 and one INT8 BERT forward under torch.profiler,
             with device ms by op type (QuantizeLinear apart from
             QLinearMatMul's own glue: any requant passes left).
11. kernel  - two lines per distinct qmatmul_int8 shape of that run, on its
             real operands: the requant epilogue (the main path) bit-equal
             to qmatmul_int8_requant_plain and the int32 epilogue bit-equal
             to qmatmul_int8_plain on the card; kernel and library
             (torch._int_mm) times from a replayed CUDA graph, the plain
             time, the card's bound, TOP/s and GB/s.
12. ort_decode - the GPT-2 decode path of phase 6, at GPT2_SIDE_LAYERS
             (4) of its 12 layers, with every MatMul that
             quantize_weights_int4 would take rewritten into the interleaved
             ORT MatMulNBits form (quant.pack_int4, no `layout`), carried
             as ONNX bytes into the Generator: 4L + 1 (17) qmatmul_int4_bf16
             launches per prefill (on mma) and per step (on small_m), none
             planar;
             prefill + 4 steps
             re-run through the plain versions on the CPU (logits within
             1e-2 * max|logit|); tokens/s.
13. kernel  - one line per distinct qmatmul_int4_bf16 shape (M = 8 step,
             M = 512 prefill), within 1e-5 * max|out| of the plain version
             on the card, timed as in phase 8.
14. int4_m_sweep - both int4 kernels at K = 768, N = 2304 for M = 1, 8,
             16, 32, 64, 128, 512: every schedule that takes the shape
             (checked against the plain version) and the library call,
             timed; where small_m stops beating mma (the crossover).
15. capture - twice, after phase 5 (SqueezeNet INT8 at b256) and after
             phase 11 (INT8 BERT at B 32, T 128): the Engine's captured CUDA
             graph (Engine.__call__ captures on a signature's first call)
             against its eager function on the same inputs, bit for bit,
             for the main path's input and a second one; a returned output
             not overwritten by the next call; launch counts per forward
             over replays unchanged (26 convs: 17 TMA + 5 halo + 4 gather, conv1 s2d; 73 GEMMs,
             all requant); wall per forward eager, replayed through
             Engine.__call__ and as the bare graph replay, each beside the
             device busy time from torch.profiler (idle share).
16. device_loop - after phase 7: phase 6's Generator with device_loop = 8
             (K steps as one replayed CUDA graph): greedy tokens equal the
             host loop's with ORIET_ATTN_I8 unset and set, a seeded
             sampled run bit-equal to the host loop's, 49 int4 and 12
             attention launches per step over the replays; tokens/s of
             both loops, also with an eos id no row emits (the host loop
             then reads `done` every step, the device loop once a block);
             a block's wall against its device busy time.
17. serve   - after phase 14: DecodeServer on GPT-2 124M's widths at
             GPT2_SIDE_LAYERS (4) of its 12 layers (8 slots, INT4
             planar weights, INT8 KV, max_len 256, prompt buckets 16/32/
             64), 16 requests with prompts of 16-64 tokens from
             default_rng(0) and 64 new tokens each, at multi_step 0 and 8
             (a warm-up request per bucket first): the tokens of
             multi_step 8 equal multi_step 0's for every request;
             agreement of the first 2 with an isolated batch-1 Generator
             reported, not held; served tokens/s, p50/p99 request latency,
             a K-step replay's wall against its device busy time. Then
             InferenceServer on SqueezeNet 1.0 INT8 at 224x224, buckets
             1/8/64/256 (warmup captures each), 120 requests of 1-8
             images: every served batch equal to the Engine's eager run
             on the same padded batch, every request's rows a slice of
             one; images/s, p50/p99, each Engine call's ms, and a b256
             batch's pageable copy to the card and np.concatenate alone.
18. llama   - after phase 17: the Llama decoder (GQA, RoPE, SwiGLU,
             RMSNorm) at LlamaConfig()'s widths (dim 4096, 32 heads on 8 KV
             heads of 128, FFN 16384, vocab 32000) with LLAMA_LAYERS (1)
             of its 32 layers, random weights from seed 0 (host build
             seconds printed). Generator(family="llama") with INT4 planar
             weights, an INT8 KV cache and fused attention at phase 6's
             batch, prompt, max_len and new tokens: counts set to 0 just
             before, read just after, for L layers: 7 L + 1 int4 launches
             per prefill (all on mma) and per step (6 L + 1 on small_m, the
             L down projections at K = 16384 on mma: every launch on
             int4_schedule's pick), L attention launches per step;
             prefill + 4 steps re-run through
             the plain versions on the CPU (logits within 1e-2 *
             max|logit|). The same with ORIET_ATTN_I8=1 (its own counts);
             device_loop = 8 (tokens equal the host loop's, counts over the
             replays); one step under torch.profiler (busy share by
             bucket); the kernel lines of every int4 shape of the path and
             of both attention kernels at its GQA shape (32 / 8 heads of
             128, L 256). Then kv_dtype="int4" unfused (counts, CPU
             re-run); DecodeServer(family="llama") with 8 slots, buckets
             16/32/64, 16 requests of 16-64 prompt tokens x 32 new at
             multi_step 0 and 8: tokens equal. Tokens/s, step wall and
             busy for information.
19. vision  - after phase 18: ResNet-50, MobileNetV2 and ViT, random
             weights from seed 0, at full width. Goldens on the card
             (ResNet-50 at 64x64, MobileNetV2 at 96x96, ViT TINY; b1;
             tests/goldens/, rtol = atol = 1e-3). Then ResNet-50 and
             MobileNetV2 at 224x224, b256, and ViT-B/16 (ViTConfig(): 224,
             patch 16, hidden 768, 12 x 12 heads) at b64, inputs from
             default_rng(0): fp32 Engine, calibrate on x[:8] (ViT: a b8
             build of the same seed), quantize_graph, INT8 Engine, each
             forward a captured graph. Counts set to 0 just before, read
             just after, exact per INT8 forward: ResNet-50 53
             qconv_int8_requant + 1 qmatmul_int8; MobileNetV2 35 +
             17 qconv_grouped_int8_requant + 1; ViT-B/16 1 + 73; producers,
             grouped forms and epilogues as the shapes predict. Every
             distinct QLinearConv (grouped too) and QLinearMatMul shape
             bit for bit against its plain version on the card's own
             inputs (one kernel line each, `"path": "vision"`; a grouped
             line adds its plan's form, tile, channel run, box, threads
             and shared memory, and where the plan takes all of C as one
             channel run, the time of the run TILE_RUNS alone would give
             on the same inputs; then one `grouped_conv` line: the 17
             launches' ms, GB/s and share of the bound beside the first
             design's recorded 3.482 ms), every
             QLinearAdd against its plain re-run on the CPU for the first
             4 images; INT8 against fp32 at the JAX tests' bounds (ResNet:
             top-1 equal or max |d| / max|ref| < 0.1; MobileNetV2: top-1
             or max |d| < 0.15; ViT: correlation > 0.95); channels-last
             kept through QLinearConv and QLinearAdd; images/s from
             replayed graphs; the profile of one fp32 and one INT8
             forward. InferenceServer on ResNet-50 INT8 (buckets
             1/8/64/256, 120 requests of 1-8 images): every response
             within 1e-3 of an eager Engine call on the same images. The
             CLI as subprocesses: `run` with resnet50.pb's golden case
             (MATCH), `inspect` of the three models (no unsupported op),
             `bench --quantize int8 --batch 256`.
18c. scan_decode - after phase 18: the scan-over-layers decode graphs
             (Generator(scan_layers=True): one Scan over stacked per-layer
             weights, stacked KV cache) with INT4 planar weights and an
             INT8 KV cache, attention unfused (JAX takes no fused attention
             with scan_layers), against the per-layer Generator with the
             same arguments: GPT-2 124M (all 12 layers: its Scan iterates
             12 times) and Llama at LlamaConfig()'s widths with 1 of 32
             layers (phase 18's depth and weights; its Scan runs once),
             batch 8, 64-token prompts, max_len 256, 64 greedy tokens.
             Counts set to 0 just before each form's main path and
             read just after: 49 (Llama: 8) int4 launches per prefill and
             per step in both forms, each on the schedule int4_schedule
             picks, no other kernel; tokens equal; the prefill and 4
             teacher-forced steps of both forms equal bit for bit (logits
             and every layer's cache); the scan form's prefill and 4 steps
             re-run through the plain versions on the CPU (logits within
             1e-2 x max|logit|). Per form: the replayed step (device busy
             and wall ms, device ops), tokens/s, copy and concat kernels
             per step (the Scan's stacked outputs); then the scan form with
             device_loop = 8 (tokens equal its host loop's, int4 launches
             per step over the replayed blocks, tokens/s). GPT-2's kernel
             lines of the scan form's int4 shapes, on layer 0's slices of
             the stacked weights; one line per model.
18d. control_flow - after 18c: ONNX If / Loop / Scan, sequence state and
             LSTM / GRU / RNN graphs built from seed 0, each through an
             Engine on the card (first call eager then captured, replays,
             eager forwards) against the port's CPU run of the same graph
             and feed, TF32 off: an If on a predicate computed at run time
             over [4096, 1024] f32 branches (both values, one captured
             graph); a Loop of 32 trips over a [1024, 1024] state that exits
             after 20; a Loop with a tensor and a sequence state (8 trips,
             ConcatFromSequence, SequenceLength); a reverse Scan over two
             scan inputs (T 64, the second on its axis 1, output reversed
             on axis 1); a bidirectional LSTM, a GRU and an RNN at T 128,
             B 64, input 512, hidden 512. Bounds: 1e-5 x max|out| for
             If/Loop/Scan, rtol 1e-4 / atol 1e-5 for the RNNs. One line
             per graph: the errors, the replayed ms (device busy and wall),
             device ops per replay, eager wall ms.
18b. precision - after phase 18: the bf16 dtype policy and dynamic W8A8
             (quantize_matmuls_w8a8, MatMulInteger on the int8 kernel's
             int32 epilogue). BERT-base at B 32, T 128 (phase 9's inputs)
             as Engine(g), Engine(g, dtype="bfloat16") and
             Engine(quantize_matmuls_w8a8(g)): sequences/s from replayed
             graphs, bf16 and W8A8 against fp32 (max |d| / max|ref|,
             bounds 0.02 and 0.1); counts set to 0 just before the W8A8
             Engine's first call and read after its replays: 73
             MatMulInteger launches a forward, all on the int32 epilogue,
             no other kernel; each distinct MatMulInteger shape on the
             card's own int8 activations bit-equal to qmatmul_int8_plain,
             timed beside torch._int_mm on a column-major B (kernel
             lines, "path": "precision"). GPT-2 124M's widths at
             GPT2_SIDE_LAYERS (4) of 12 layers and the phase-18 Llama at
             batch 8,
             prompt 64 through Generator(prefill_dtype=...) in fp32,
             bfloat16 and w8a8, without and with int4_weights: one launch
             per MatMulInteger and per MatMulNBits in the first prefill,
             prefill tokens/s replayed, device ms by op type (no int4),
             logits against fp32 (W8A8: rel < 0.05 for GPT-2, 0.1 for
             Llama, and top-1 flips within 0.15 of bf16's), then 4 decode
             steps; Llama's W8A8 error again on weights and prompts from
             seed 1. The bf16 Llama prefill's int4 calls that take bf16
             A (planar weights; and the same prefill on ORT-layout
             weights, interleaved) on their own activations (probe_graph
             on the MatMulNBits inputs) within 1e-5 x
             max|out| of the plain twins and equal to the kernel on the
             same values as f32 A, timed beside torch._weight_int4pack_mm
             with bf16 A. DecodeServer(prefill_dtype="w8a8") on GPT-2 124M's
             widths (GPT2_SIDE_LAYERS layers)
             serving 16 requests: tokens/s; then 16 requests queued in
             two waves of 8 with one prompt length each (64, 32) before
             a second server starts, so each wave's rows line up as an
             isolated Generator(batch=8, prefill_dtype="w8a8")'s do:
             every served token equal to that Generator's.
19b. qoperator - after phase 19: ONNX Runtime's QOperator INT8 files
             (tests/torch_port_qoperator.py: quantize_static's QOperator
             form, per-channel int8 weights, asymmetric activations) of
             SqueezeNet 1.0 and MobileNetV2 at 224x224, b256, random
             weights from seed 0, calibrated on x[:8], in both activation
             types (QUInt8, QInt8), as ONNX bytes through an Engine each
             (every forward a captured graph). Counts set to 0 just before
             each form's Engine and read just after its forwards:
             SqueezeNet 26 qconv_int8_requant per forward, MobileNetV2 35 +
             17 qconv_grouped_int8_requant + 1 qmatmul_int8 (its QGemm),
             every QUInt8 conv on the kernel's uint8-A instance, per form
             (uint8 x, zero-point pad, y zero point, uint8 y); each kernel
             row's launches are these counts. Every kernel call of an eager forward of each file equal
             to its plain version on the card's own operands (kernel lines,
             "path": "qoperator"); the QUInt8 forward, every quantized
             tensor less 128, equal to the QInt8 one; INT8 against fp32
             (SqueezeNet: top-1 equal or rel < 0.1; MobileNetV2: top-1
             equal or max |softmax d| < 0.15); images/s; device ms by op
             type. A ConvInteger node (uint8 x, per-channel w zero point)
             on the int32 epilogue, exact. The CLI as subprocesses:
             `quantize --calibration mse --bias-correct` and minmax
             `quantize` on SqueezeNet, `run` on both files; mse + bias
             correction's mean |INT8 - fp32| on 64 held-out images below
             minmax's.
19c. export - after phase 19b: four Engines built from ONNX files as a
             user builds them (import_onnx, calibrate + quantize_graph, or
             quantize_weights_int4; random weights from seed 0):
             SqueezeNet 1.0 INT8 and MobileNetV2 INT8 at 224x224, b256,
             BERT-base INT8 (EXPORT_BERT_LAYERS = 2 of its 12 layers,
             full widths; cut for the time limit) at B 32, T 128, and
             GPT-2 124M's INT4-planar, INT8-KV, fused-attention decode
             step (EXPORT_GPT2_LAYERS = 2 of its 12 layers, full widths;
             cut for the time limit) at batch 8, max_len 256.
             Each is written with export_aot.export_engine and loaded and
             run in a fresh process (this script with --export-child),
             which must import no ONNX codec, graph or op registry (it
             exits non-zero otherwise): its outputs, eager and replayed,
             equal the Engine's bit for bit, its launches per replayed
             forward equal the Engine's kernel by kernel and split by
             split. One line per model: the artifact's bytes and the weight
             bytes it holds, the export seconds, the cold start (process
             start to first output) of the artifact and of the importer
             path (import_onnx -> quantize -> Engine) in a fresh process,
             the two processes started together, and both replayed
             throughputs (CUDA events, device-resident inputs; the
             artifact's once the importer's process has exited). Then the CLI's `profile` on SqueezeNet INT8 at b256:
             its trace must hold a QLinearConv range per node and forward,
             every int8 conv launch under one. The phase's seconds on a
             line of their own.
19d. op_library - after 19c: the op library the port took over from the JAX
             package's ops/standard.py, ops/extra.py,
             ops/contrib_transformers.py and ops/core_attention.py. Every case
             of tests/torch_port_oplib.py (one or more per op: attribute
             variants, TopK ties, every Pad mode, every Resize mode and
             coordinate transform, the spec's forms where the JAX emitter
             differs, the random ops) as a one-node graph through an Engine on
             the card, eager and replayed (one captured graph), against the
             port's CPU run of the same graph and inputs: exact for integer,
             boolean and index outputs, else the case's CPU-test tolerance; one
             line per emitter module with its worst errors. The ORT attention
             ops (Attention, MultiHeadAttention, SkipLayerNormalization, the
             core Attention) at BERT-base widths (B 32, T 128, 12 x 64) and
             GroupQueryAttention at Llama's heads (32 on 8 of 128, B 4, S 256),
             against the CPU (rtol 1e-4, atol 1e-4) and timed replayed. Then
             UNet (UNetConfig(): base 16, depth 3, 2 classes) at 256x256, b32,
             fp32 and INT8 (calibrate on x[:8], quantize_graph: 11
             QLinearConvs, the 3 ConvTransposes fp32), and the audio encoder
             (AudioEncoderConfig(): whisper-tiny's front end and widths) on
             30 s clips (480,000 samples, 2,998 frames, 1,499 positions), b16;
             random weights from seed 0, inputs from default_rng(0), each
             forward a captured graph. Cases of ops with no emitter (Shape,
             Size, Constant, ConstantOfShape, Range) run the static path and
             report as module "static". The first 2 images / clips against the
             port's CPU run (fp32 within 1e-5 x max|ref|, the same forward
             eager under a caller's TF32 flags held to the same bound, and what
             TF32 does to one conv and one matmul at the families' widths
             beside it; INT8 at most 1 step of the output's scale from the
             CPU's INT8); counts set to 0 just before the INT8 UNet's first
             call and read after its forwards: 11 qconv_int8_requant launches a
             forward, no other kernel; INT8 UNet's per-pixel argmax agreement
             with fp32 > 0.95 (the JAX test's bound); images/s and clips/s from
             replays; device ms by op type; a kernel line per distinct
             QLinearConv shape of the INT8 UNet (bound, plain) and
             torch._int_mm's time on its 1x1 head conv (row 1's
             `unet_path`). The op library's cases include the bounded,
             loss, RoI and ai.onnx.ml ops (numeric labels).
19e. detection_ml - after 19d: each forward one captured graph, replayed,
             with its replayed ms and peak device memory
             (max_memory_allocated), weights from seed 0, inputs from
             default_rng(0): the SSD family (DetectionConfig(320, 80
             classes, 2 anchors, 64 channels, 100 boxes a class, IoU 0.5,
             score 0.05), b8: 12,800 boxes, 64,000 rows) with in-graph
             NMS, its first image against the port's CPU run at b1 (boxes
             and scores within 1e-5 x max|ref|), the NMS node bit for bit
             (the card's boxes and scores of the first 2 images through
             the CPU NMS give the card's rows), the rows of image 0 that
             differ end to end counted, the NMS alone replayed; XGBoost's
             binary trees (500 of depth 8, 28 features, one-sided
             logistic, the blocked layout) behind Imputer and Scaler with
             ZipMap after, b4096: the first 256 rows' labels equal and
             probabilities within 1e-5 of the CPU, ZipMap's maps equal to
             the probabilities; an RBF SVC (10 classes, 784 features,
             4,000 support vectors, Platt pairwise coupling), b1024: the
             first 128 rows as the trees; a text pipeline (StringNormalizer
             -> StringSplit -> TfIdfVectorizer, 1- and 2-grams, pool
             20,000 -> LinearClassifier, 20 classes) on 256 documents of
             200 tokens from a 5,000-word vocabulary: the host prolog's ms
             and the device's apart, the whole batch against the CPU; RoI
             heads (RoiAlign on [2, 256, 200, 272], 1,000 rois, 7x7, ratio
             2, scale 0.25; MaxRoiPool on [1, 512, 38, 50], 300 rois, 1/16;
             DeformConv v2 on [8, 256, 50, 68], 3x3, 256 out, with mask):
             the first 64 rois or the first image against the CPU at
             test_roi_ops.py's bounds; SoftmaxCrossEntropyLoss over [8,
             50257, 128] with ignore_index -100 on 10% of targets, mean,
             against the CPU (rtol 2e-5). The phase's peak under 25 GB.
6b. families - the model families at full width (its multi-LoRA path
             after phase 8, on phase 6's Generator; the others after
             19e), every decode step a captured graph, replayed,
             weights from seed 0, inputs from default_rng(0); each path's
             line has its rate, peak device memory
             (max_memory_allocated) and launches. Multi-LoRA GPT-2 124M
             (make_adapter_stack: 8 adapters of rank 16 over the attn and
             mlp projections, alpha 16; INT4 weights, INT8 KV, fused
             attention): adapter 0 on every row gives phase 6's logits bit
             for bit, with 49 int4 and 12 attention launches per step; an
             8-slot DecodeServer serves one request per adapter, each
             token of it the pick of an isolated batch-1 Generator on that
             adapter (16 new tokens), teacher-forced on the served
             tokens with the server's KV scales, or a near-tie there (a
             top-2 margin under NEAR_TIE of the logits' range: the server
             decodes at M = 8), and not adapter 0's picks; an fp32 b8 x
             128 prefill with row k on adapter k within 1e-4 x max|ref|
             of fold_adapter(k)'s graph.
             The MoE decoder at GPT-2 small's widths with Switch-base-8's
             8 experts of d_ff 3072, MOE_LAYERS of 12 layers deep: the
             fp32 b8 x 128 prefill's first 2 rows within 1e-5 x max|ref|
             of the CPU, the routed-expert histogram and the smallest
             router margin, 8 decode steps against the prefill (1e-4);
             INT4 + INT8 KV, 16 new tokens, the host loop and
             device_loop 8 with equal tokens, int4 launches per step the
             decode graph's MatMulNBits count; an 8-slot server against
             isolated runs, as for LoRA. T5-small (T5Config()) through
             Seq2SeqGenerator at b16, src 512, max_len 128, 32 new
             tokens: fp32, the first 2 rows' encoder output and cross K/V
             and each teacher-forced step's logits within 1e-4 x max|ref|
             of the CPU (T5_REL_TOL: T5's unscaled scores amplify
             rounding, so that an fp32 run is ~3e-5 from a float64 one),
             with the readings behind that bound (the CPU's and the
             card's encoder against a float64 CPU run, and the card's
             with TF32 on against the CPU); INT8 KV (calib_steps 4) with
             INT4 weights, the
             int8 cache and scales at the switch byte for byte numpy's
             quantization of the card's own fp32 cache, int4 launches per
             encoder call and per step each graph's MatMulNBits count.
             Whisper-style ASR (ASRConfig(): whisper-tiny's front end and
             encoder, 2 decoder layers) on 30 s clips at 16 kHz, b8, 32
             new tokens, the first clip against the CPU at 1e-5, as T5
             (fp32 and INT8 KV). The port's benchmarks/accuracy.py on
             SqueezeNet 1.0 (8 x 32 held-out inputs): its three lines
             (INT8 values reported, not held), 26 int8 conv launches per
             INT8 forward, the fp32 top-1 of the first batch equal to the
             CPU's (near-ties, a top-2 margin under 1e-4 of the range,
             excused).
6c. decoding - decoding beyond greedy and the rest of serving (after
             6b), weights from seed 0, one line per path. Beam search on
             GPT-2 124M with INT4 weights (BeamGenerator, b4 x beam 4,
             prompt 64, 32 new): the host loop and the device loop (every
             step after the first one CUDA graph, its first call eager
             and captured, the timed call a replay) give the same beams,
             scores within 1e-5 relative; 49 qmatmul_int4_planar launches
             per prefill and per step on both loops; beam=1's tokens the
             picks of an isolated batch-1 greedy Generator teacher-forced
             on them (near-ties, NEAR_TIE, excused); tokens/s of both
             loops and the block's replay ms. Seq2SeqBeamGenerator on
             T5-small (b4 x beam 4, src 512, 32 new): both loops agree.
             SpeculativeGenerator on GPT-2 124M's widths at
             GPT2_SIDE_LAYERS (4) of 12 layers, fp32 (b8, prompt 64, k 4,
             32 new), the draft the target (acceptance 1.0) and a 2-layer
             draft at the same widths (draft_seed 1, as the CLI's
             --draft-layers builds it): rows that differ from the greedy
             Generator's teacher-forced against the isolated one;
             acceptance and tokens/s beside the greedy Generator's.
             SpeculativeServer (the same 4-layer target; 8 slots, 16
             requests of 48 repeated-motif
             tokens x 32 new, k 4): the 2-layer draft and prompt lookup
             (ngram 2), each in host rounds and in blocks of 4 rounds;
             the first run's first 4 requests, and any request another
             run serves otherwise, teacher-forced against the isolated
             greedy Generator; every cache row finite after each run
             (parked lanes'); a sampled request's tokens alone equal its
             tokens beside 7 greedy ones (the block's seed contract).
             Seq2SeqServer on T5-small (8 slots, 16 requests of 512
             tokens x 32 new, encoder_cache 4, one source repeated) at
             multi_step 0 and 8: one encoder-cache hit each, every token
             the pick of a batch-16 Seq2SeqGenerator teacher-forced on the
             served tokens.
6d. int8_whole - the INT8 path and the front end made whole (after 6c),
             weights from seed 0, one line per path. `native`: the native
             C++ parser (native_loader, built with g++ into build/native)
             and the Python codec parse SqueezeNet 1.0's, BERT-base's and
             GPT-2 124M's bytes to ModelProtos equal field by field, both
             parse times on the card's host; a build failure fails it.
             `r3d18`: R3D-18 (tests/torch_port_video.py, published widths,
             BatchNorm folded) on b16 clips of 3x16x112x112, fp32 and INT8
             (calibrated on x[:2]); counts set to 0 just before, read just
             after: 20 qconv_int8_requant launches per INT8 forward, every
             one the 3-D form (the 13 stride-1 3x3x3 convs and the stem,
             as its space-to-depth rewrite, on the staged-halo producer,
             the other 6 on the gather), and the
             fc's qmatmul_int8; every kernel call of a forward bit-equal to
             its plain version on the card's operands for the first 2
             clips, and listed with its plan, ms and bound; clips/s; INT8
             against fp32. `depthwise3d`: a depthwise 3x3x3 QLinearConv at
             R3D layer1's activation (b16, 64 channels, 16x56x56) on the
             grouped kernel's tile3d form, and a 3-D ConvInteger there
             with a per-channel w zero point, exact (its int32 sums on the
             general form).
             `squeezenet_dynamic`: SqueezeNet 1.0 in ONNX Runtime's
             quantize_dynamic form (tests/torch_port_dynamic.py) at b256:
             26 ConvInteger launches per forward, each reading its pad
             value from device memory (`device_zero_point`; 15 by TMA, 7
             on the staged-halo producer, conv1 as its space-to-depth
             rewrite among them, 4 gather), each call's
             int32 bit-equal to its plain version (2 images), the captured
             graph replayed on two inputs whose zero points differ, each
             equal to its eager run; images/s. `runtime_zp`: one-node
             QLinearConv, QLinearMatMul and QGemm with run-time x and y
             zero points, eager and replayed, equal to the CPU. `bf16_input`:
             a BFLOAT16 graph input fed a bf16 tensor, equal to the CPU.
6e. parallel - the mesh on the card, a world of one rank on NCCL (after
             6d), weights from seed 0, one line per path with the backend,
             the world size, the mesh, `shard_routes` (the sharded
             Engine's nodes by route) and the rate beside the unsharded
             run's on the same card (the collectives' cost at one rank,
             not scaling). `squeezenet_int8`: SqueezeNet 1.0 INT8 224x224
             b256 through Engine(mesh={data: 1, model: 1},
             cnn_param_sharding, data_input_sharding): 26
             qconv_int8_requant launches a forward, the output bit-equal
             to the unsharded INT8 Engine's, its replay to its eager run.
             `gpt2_tensor`: GPT-2 124M's widths at GPT2_SIDE_LAYERS layers,
             INT4 planar + INT8 KV + fused attention, b8, prompt 64, 16 new
             tokens, through Generator(mesh=, param_sharding_fn=the
             north-star rule of tests/test_gpt2.py), host loop and
             device_loop=8: tokens and int4 / attention launches equal
             the unsharded Generator's. `gpt2_pipeline`: the same model
             (unfused attention) through Generator(mesh={pipe: 1},
             pipeline_axis="pipe"), both loops, tokens and launches equal.
             `decode_server`: a DecodeServer sharded by the same rule, 8
             slots, 8 requests x 16 tokens, served tokens equal the
             unsharded server's.
20. kernels - one line listing every ported kernel, one per TPU kernel,
             and the grouped int8 conv, which has no TPU kernel behind it,
             then the bf16-and-W8A8 instances (qmatmul_int8's MatMulInteger
             route, both int4 kernels with bf16 A), after a line with the
             script's seconds so far; the rows of the
             kernels the Llama path runs carry its numbers in `llama_path`,
             those of the vision path in `vision_path` (by model); then one
             row per kernel and QOperator form of phase 19b (`instance`,
             sums per forward of its first model, the others in
             `qoperator_path`; launches from each form's own counts).
             qmatmul_int4_planar's row carries the GPT-2 scan form's step
             in `scan_path`; the rows of the kernels the families run
             (int4 planar, decode attention, the int8 conv) carry their
             launches by path in `families_path`, and int4 planar's row
             the beam path's launches (6c) in `decoding_path`; then the
             rows of 6d's new instances (the 3-D conv, the 3-D grouped
             conv, the device-zero-point form), each with `instance`;
             the rows of the kernels 6e runs carry their launches by path
             in `parallel_path`.

The whole run is one models.host_memo block: every GPT-2 and Llama graph
of one config and seed (Generators, servers, precision schemes, export
files) draws and int4-packs its weights once. Every phase line carries
t_s, the script's seconds so far.

Then the nvidia-smi line again and, last, {"ok": true, "device": ...}. Any
failed check raises: the script exits non-zero and prints no last line. It
fails the same way without a CUDA device, or when the package is not beside
it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "onnx_rusty_inference_engine_tpu_torch"

BATCH = 256
CALIB = 8          # calibration images, as bench.py calibrates on x[:8]
# SqueezeNet 1.0's 26 group-1 convs at b256 by A producer, in the static
# and QOperator INT8 forms (the requant epilogue): the 1x1s by TMA; conv1
# (stride 2, 3 channels, as its space-to-depth rewrite: a stride-1 4x4
# over 16 channels, the `s2d` form) and the 3x3 expands of fires 2-5 (N 64
# and 128) on the staged-halo producer; the expands of fires 6-9 (N 192
# and 256 over 26 x 26 and 12 x 12, which conv_plan's fallback rule keeps
# there) on the gather. ORT's dynamic ConvInteger form (the int32
# epilogue) has the expands of fires 8-9 (N 256) on the staged-halo
# producer too, and the expand1x1 of fires 2-3 (C 16) on the gather
# (conv_plan's rules).
SQUEEZENET_PRODUCERS = {"tma": 17, "halo": 5, "gather": 4}
SQUEEZENET_DYNAMIC_PRODUCERS = {"tma": 15, "halo": 7, "gather": 4}
CPU_CHECK = 8      # images re-run through the plain versions on the CPU
WARMUP, ITERS = 3, 20

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

# GPT-2 decode path
DEC_BATCH, PROMPT, MAX_LEN, NEW = 8, 64, 256, 64
# GPT-2 124M's depth, at its full widths, on the side paths that repeat
# phase 6's per-layer shapes: the ORT-layout decode (12), the DecodeServer
# (17), the precision phase's GPT-2 prefill schemes and W8A8 server (18b)
# and the speculative target of 6c (its draft: SPEC_DRAFT_LAYERS). The
# smoke's time limit; phases 6, 6b, 6c's beam paths and 18c run all 12.
GPT2_SIDE_LAYERS = 4
GPT2_SIDE = f"gpt2 124M widths, {GPT2_SIDE_LAYERS} of 12 layers, seed 0"
CPU_STEPS = 4       # decode steps re-run through the plain versions
DEC_ITERS = 50      # timed launches per decode kernel shape

BF16_OPS_PER_S = 989e12

# BERT-base INT8 encoder path
BERT_BATCH, BERT_SEQ = 32, 128
BERT_CALIB = 8      # calibration sequences
BERT_CPU = 8        # sequences re-run through the plain versions on the CPU

KERNEL_ROWS = {  # name -> (source, TPU kernel it replaces)
    "qconv_int8_requant": (
        f"{PKG}/csrc/qconv_int8.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py:102"),
    "qconv_grouped_int8_requant": (
        f"{PKG}/csrc/qconv_grouped_int8.cu",
        "no Pallas counterpart: XLA conv in JAX "
        "(onnx_rusty_inference_engine_tpu/ops/quantized.py:127-136)"),
    "qmatmul_int8": (
        f"{PKG}/csrc/qmatmul_int8.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul.py:58"),
    "qmatmul_int4_bf16": (
        f"{PKG}/csrc/qmatmul_int4.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul_int4.py:75"),
    "qmatmul_int4_planar": (
        f"{PKG}/csrc/qmatmul_int4.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/qmatmul_int4.py:200"),
    "decode_attention_int8": (
        f"{PKG}/csrc/decode_attn.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/decode_attn.py:60"),
    "decode_attention_int8_mxu": (
        f"{PKG}/csrc/decode_attn.cu",
        "onnx_rusty_inference_engine_tpu/ops/kernels/decode_attn.py:147"),
    "nibble_probe": (
        f"{PKG}/csrc/nibble.cuh",
        "experiments/cast_probe.py:7"),
}


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the script's seconds so far
    (`t_s`), so that a run cut at its time limit shows where it was."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _wrappers():
    """Every kernel wrapper, by kernel name; each counts its launches."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import counters

    return counters.wrappers()


# the per-variant counts some wrappers keep beside `launches`: int4
# schedules, int8 GEMM epilogues, int8 conv A producers
_SPLITS = ("schedules", "a_dtypes", "epilogues", "producers", "forms")


def reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
        for split in _SPLITS:
            if hasattr(w, split):
                setattr(w, split, dict.fromkeys(getattr(w, split), 0))


def read_splits(name: str) -> dict:
    """The per-variant launch counts of one kernel's wrapper."""
    w = _wrappers()[name]
    return {split: dict(getattr(w, split)) for split in _SPLITS
            if hasattr(w, split)}


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: w.launches for name, w in _wrappers().items()}


def bound(ops: float, nbytes: float, ops_per_s: float):
    """(bound_ms, bound_by, ops_ms, bytes_ms) for work of `ops` operations
    moving `nbytes` bytes on the H100."""
    ops_ms = ops / ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Mean device ms per call of fn with no host time between calls: the
    calls are captured once into a CUDA graph and the graph is replayed
    (a decode kernel runs for microseconds, less than its wrapper's host
    time, so eager back-to-back calls would time the host)."""
    from onnx_rusty_inference_engine_tpu_torch.engine import collector_held

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_held(), torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build() -> None:
    """Every kernel source (one nvcc each, all at once) and, beside them on
    a thread, the native C++ ONNX parser (g++), so that the CLI's child
    processes find it built."""
    import threading

    from onnx_rusty_inference_engine_tpu_torch import native_loader
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    native = {}

    def build_native():
        native["lib"] = native_loader.get_lib()
        native["s"] = time.perf_counter() - t0

    thread = threading.Thread(target=build_native)
    thread.start()
    built = _build.build_all()
    thread.join()
    require(native["lib"] is not None, "the native parser builds")
    # each kernel's entry line, then its registers, shared memory and spills
    regs = {name: [ln.strip() for ln in info.log.splitlines()
                   if "entry function" in ln or "registers" in ln
                   or "spill" in ln or "arning" in ln]
            for name, info in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(built), "ptxas": regs,
          "native_parser": {"library": native_loader.library_path(),
                            "seconds": native["s"]}})


def _squeezenet_golden_input() -> np.ndarray:
    """The b1 input tests/test_regression_goldens.py::_cases draws for its
    squeezenet case: default_rng(123) after three earlier draws."""
    rng = np.random.default_rng(123)
    rng.standard_normal((1, 3, 64, 64))
    rng.standard_normal((1, 3, 96, 96))
    rng.integers(0, 128, (1, 8))
    return rng.standard_normal((1, 3, 224, 224)).astype(np.float32)


def phase_slice():
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.debug import (
        dump_intermediates, intermediates)
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels.qconv_int8 import (
        qconv_int8_requant)
    from onnx_rusty_inference_engine_tpu_torch.utils.timing import (
        engine_throughput)

    graph = P.import_model(P.build_squeezenet())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 3, 224, 224)).astype(np.float32)
    feed = {"data_0": x}

    reset_counts()
    t0 = time.perf_counter()
    # golden at b1
    golden = onnx_io.read_tensor_file(
        os.path.join(HERE, "tests", "goldens", "squeezenet.pb")).array
    eng = P.Engine(graph)
    got = eng.run({"data_0": _squeezenet_golden_input()})["softmaxout_1"]
    golden_err = float(np.abs(got - golden).max())
    require(got.shape == golden.shape and np.allclose(got, golden, rtol=1e-3,
                                                      atol=1e-3),
            f"fp32 b1 golden (max abs err {golden_err})")

    # fp32 at b256
    y32 = eng(feed)["softmaxout_1"]
    require(tuple(y32.shape) == (BATCH, 1000, 1, 1)
            and bool(torch.isfinite(y32).all()), "fp32 b256 output")
    require(bool(torch.allclose(y32.sum(dim=1), torch.ones_like(
        y32.sum(dim=1)), atol=1e-4)), "fp32 softmax rows sum to 1")
    fp32_ips = engine_throughput(eng, feed, iters=ITERS, warmup=WARMUP)

    # quantize and run INT8 at b256
    ranges = P.calibrate(graph, [{"data_0": x[:CALIB]}])
    qgraph = P.quantize_graph(graph, ranges=ranges)
    n_qconv = sum(n.op_type == "QLinearConv" for n in qgraph.nodes)
    require(n_qconv == 26, f"26 QLinearConv nodes in INT8 SqueezeNet, got "
            f"{n_qconv}")
    eng8 = P.Engine(qgraph)
    y8 = eng8(feed)["softmaxout_1"]
    torch.cuda.synchronize()
    require(qconv_int8_requant.launches == n_qconv,
            f"one kernel launch per QLinearConv ({qconv_int8_requant.launches}"
            f" for {n_qconv})")
    require(tuple(y8.shape) == (BATCH, 1000, 1, 1)
            and bool(torch.isfinite(y8).all()), "INT8 b256 output")
    int8_ips = engine_throughput(eng8, feed, iters=ITERS, warmup=WARMUP)
    int8_forwards = 1 + WARMUP + ITERS
    counts = read_counts()
    launches = counts["qconv_int8_requant"]
    main_path_s = time.perf_counter() - t0
    require(launches == n_qconv * int8_forwards,
            f"{launches} launches for {int8_forwards} INT8 forwards")
    require(sum(counts.values()) == launches,
            f"only the int8 conv kernel on SqueezeNet's path: {counts}")
    # the 17 1x1 convs (C % 16 == 0) read A by TMA, conv1 (its space-to-
    # depth rewrite) and fires 2-5's 3x3 expands from a staged halo box,
    # the other expands by the gather
    splits = read_splits("qconv_int8_requant")
    producers = splits["producers"]
    require(producers == {k: n * int8_forwards
                          for k, n in SQUEEZENET_PRODUCERS.items()},
            f"A producers per INT8 forward: {producers} for {int8_forwards}"
            f" ({SQUEEZENET_PRODUCERS} a forward)")
    require(splits["forms"]["s2d"] == int8_forwards,
            f"conv1 as its space-to-depth rewrite once a forward: "
            f"{splits['forms']} for {int8_forwards}")

    # every intermediate of the INT8 graph (debug.py), on the card at b256
    # (as device tensors, with the Engine's weights) and through the plain
    # versions on the CPU for the first CPU_CHECK images
    card = intermediates(qgraph, feed, device="cuda", params=eng8.params,
                         packed=eng8.packed)
    host = dump_intermediates(qgraph, {"data_0": x[:CPU_CHECK]},
                              device="cpu")
    n_eq = n_all = 0
    worst = 0
    for name, v in host.items():
        if v.dtype != np.int8:
            continue
        c = card[name][:CPU_CHECK].cpu().numpy()
        n_eq += int((c == v).sum())
        n_all += v.size
        worst = max(worst, int(np.abs(c.astype(np.int32) - v).max()))
    out_err = float(np.abs(card["softmaxout_1"][:CPU_CHECK].cpu().numpy()
                           - host["softmaxout_1"]).max())
    frac = n_eq / n_all
    require(frac > 0.99, f"card vs plain INT8 intermediates: {frac} equal")
    require(out_err <= 1e-3, f"card vs plain INT8 softmax: {out_err}")
    top1_agree = float((y8.reshape(BATCH, -1).argmax(1)
                        == y32.reshape(BATCH, -1).argmax(1)).float().mean())
    layouts = _layouts(qgraph, card)
    require(layouts["QLinearConv"]["channels_last"]
            == layouts["QLinearConv"]["outputs"] == n_qconv,
            f"every QLinearConv leaves channels-last: {layouts}")
    emit({"phase": "slice", "model": "squeezenet1.0 224x224", "batch": BATCH,
          "golden_b1_max_abs_err": golden_err,
          "fp32_images_per_s": fp32_ips, "int8_images_per_s": int8_ips,
          "int8_over_fp32": int8_ips / fp32_ips,
          "qlinearconv_nodes": n_qconv, "int8_forwards": int8_forwards,
          "qconv_launches": launches, "qconv_producers": producers,
          "launches_per_int8_forward": launches / int8_forwards,
          "int8_vs_plain_equal_fraction": frac,
          "int8_vs_plain_max_lsb": worst,
          "int8_vs_plain_softmax_max_abs_err": out_err,
          "int8_vs_fp32_top1_agreement": top1_agree,
          "layout_by_op": layouts,
          "main_path_seconds": main_path_s})
    return eng, qgraph, eng8, card, launches, feed


def _layouts(graph, values) -> dict:
    """By op type: the 4-D outputs on the card, how many are channels-last,
    and how many had a channels-last 4-D input but are not (a layout the op
    dropped). A tensor whose H = W = 1 counts as channels-last."""
    def cl(t):
        return t.dim() == 4 and t.is_contiguous(
            memory_format=torch.channels_last)

    out = {}
    for node in graph.nodes:
        for name in node.outputs:
            t = values.get(name)
            if t is None or t.dim() != 4:
                continue
            row = out.setdefault(node.op_type, {"outputs": 0,
                                                "channels_last": 0,
                                                "dropped": 0})
            row["outputs"] += 1
            row["channels_last"] += cl(t)
            row["dropped"] += (not cl(t)) and any(
                cl(values[i]) for i in node.inputs if i in values)
    return out


# device kernel name fragment -> bucket, first match wins
_BUCKETS = (("qconv_int8_requant", "qconv_int8_requant (int8 conv)"),
            ("qconv_s2d", "qconv_s2d (the stem's space-to-depth layout)"),
            ("max_pool", "max-pool"), ("CatArray", "concat"),
            ("cat_", "concat"), ("softmax", "softmax"),
            ("reduce", "reductions (GlobalAveragePool)"),
            ("conv", "fp32 conv (cuDNN)"), ("gemm", "fp32 conv (cuDNN)"),
            ("sm90", "fp32 conv (cuDNN)"), ("xmma", "fp32 conv (cuDNN)"),
            ("elementwise", "elementwise / copies"),
            ("copy", "elementwise / copies"))


def phase_profile(eng, eng8, feed, reps: int = 3, *, model: str = "",
                  batch: int = BATCH, buckets_by=_BUCKETS,
                  glue_op: str = "QLinearConv") -> None:
    from torch.profiler import ProfilerActivity, profile

    dev_feed = {k: torch.as_tensor(v, device="cuda") for k, v in feed.items()}
    for name, e in (("fp32", eng), ("int8", eng8)):
        with torch.no_grad():
            e._fn(e.params, dev_feed)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    e._fn(e.params, dev_feed)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels = {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / reps
        buckets = {}
        for kname, ms in kernels.items():
            b = next((label for frag, label in buckets_by
                      if frag in kname), "other")
            buckets[b] = buckets.get(b, 0.0) + ms
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        # layout and dtype copies (PyTorch's copy kernels; concat excluded)
        copies = [evt for evt in prof.key_averages()
                  if evt.device_type == torch.autograd.DeviceType.CUDA
                  and "copy" in evt.key.lower() and "CatArray" not in evt.key]
        ops_ms, kernel_ops_ms = _ms_by_op(e, dev_feed, reps)
        emit({"phase": "profile", "engine": f"{model}{name}", "batch": batch,
              "wall_ms_per_forward_profiled": wall_ms,
              "device_busy_ms_per_forward": busy,
              "device_idle_share": (1 - busy / wall_ms) if busy else None,
              "buckets_ms": dict(sorted(buckets.items(),
                                        key=lambda kv: -kv[1])),
              "copy_kernels_per_forward": sum(evt.count for evt in copies)
              / reps,
              "copy_ms_per_forward": sum(kernels.get(evt.key, 0.0)
                                         for evt in copies),
              "ops_ms_per_forward": ops_ms,
              # the hand kernels' own device ms, each under its oriet:: op
              # (and so under its node's range)
              "kernel_ops_ms_per_forward": kernel_ops_ms,
              # what the emitters of the ops that run the int8 kernel still
              # launch around it: their ranges' time less the kernel's own
              f"{glue_op}_glue_ms": ops_ms.get(glue_op, 0.0) - sum(
                  kernel_ops_ms.values()),
              "top_kernels_ms": [[k[:90], v] for k, v in top]})


def _ms_by_op(e, dev_feed, reps: int) -> tuple:
    """Device ms per forward of engine e by ONNX op type, and of each hand
    kernel's op: from a profiled run, the device time of the kernels
    launched under each node's range (`<OpType>.<node>`, entered by the
    Engine itself while a profiler is active) summed by op type, and that
    under each `oriet::` op."""
    from torch.profiler import ProfilerActivity, profile

    op_types = {n.op_type for n in e.graph.nodes}
    with torch.no_grad():
        e._fn(e.params, dev_feed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                e._fn(e.params, dev_feed)
            torch.cuda.synchronize()
    ops, kernels = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        op_type = evt.key.split(".", 1)[0]
        if "." in evt.key and op_type in op_types:
            ops[op_type] = ops.get(op_type, 0.0) + us / 1e3 / reps
        elif evt.key.startswith("oriet::"):
            kernels[evt.key] = us / 1e3 / reps
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])), kernels


def _conv_work(x, w, stride, padding):
    """(operations, bytes) the conv needs: 2 * MACs over in-bounds taps,
    each input read once and the int8 output written once."""
    B, _, H, W = x.shape
    O, _, KH, KW = w.shape
    (pt, pb), (pl, pr) = padding
    OH = (H + pt + pb - KH) // stride[0] + 1
    OW = (W + pl + pr - KW) // stride[1] + 1

    def taps(n_out, k, s, lo, size):
        return sum(1 for o in range(n_out) for t in range(k)
                   if 0 <= o * s - lo + t < size)

    # w.shape[1] is C for a group-1 conv, C / group for a grouped one
    macs = (B * O * w.shape[1] * taps(OH, KH, stride[0], pt, H)
            * taps(OW, KW, stride[1], pl, W))
    nbytes = x.numel() + w.numel() + 4 * O + 4 * O + B * O * OH * OW
    return 2 * macs, nbytes


def _const(qgraph, params, name):
    """A graph constant (scale, zero point) or weight on the card."""
    v = params.get(name)
    return v if v is not None else torch.as_tensor(
        np.asarray(qgraph.constants[name]), device="cuda")


def _qconv_geometry(node, x, w):
    from onnx_rusty_inference_engine_tpu_torch.ops.standard import (
        _conv_padding)

    stride = tuple(int(s) for s in node.attr("strides", [1, 1]))
    padding = tuple(tuple(p) for p in _conv_padding(
        node, x.shape[2:], w.shape[2:], stride, (1, 1)))
    return stride, padding


def _qconv_shapes(qgraph, eng8, card, grouped: bool) -> dict:
    """The distinct QLinearConv shapes of one INT8 forward, group 1 or
    grouped: (x, w, stride, padding) -> the card's own operands and output
    for the first node of that shape, and the count per forward."""
    params = eng8.params
    shapes = {}
    for node in qgraph.nodes:
        if (node.op_type != "QLinearConv"
                or (int(node.attr("group", 1)) > 1) != grouped):
            continue
        x, w = card[node.inputs[0]], params[node.inputs[3]]
        stride, padding = _qconv_geometry(node, x, w)
        key = (tuple(x.shape), tuple(w.shape), stride, padding)
        if key in shapes:
            shapes[key]["count"] += 1
            continue
        shapes[key] = {
            "node": node.name or node.outputs[0], "count": 1, "x": x, "w": w,
            "mult": (_const(qgraph, params, node.inputs[1]).float()
                     * _const(qgraph, params, node.inputs[4]).float()
                     / _const(qgraph, params, node.inputs[6]).float()),
            "bias": params.get(node.inputs[8]) if len(node.inputs) > 8
            else None, "stride": stride, "padding": padding,
            "packed": eng8.packed.get(node.inputs[3]),
            "out": card[node.outputs[0]]}
    return shapes


def _qmm_shapes(qgraph, eng8, card) -> dict:
    """The distinct QLinearMatMul shapes of one INT8 forward: (M, K, N) ->
    the card's own operands and output for the first node of that shape,
    and the count per forward."""
    params = eng8.params
    shapes = {}
    for node in qgraph.nodes:
        if node.op_type != "QLinearMatMul":
            continue
        a, b = card[node.inputs[0]], params[node.inputs[3]]
        key = (a.numel() // a.shape[-1], *b.shape)
        if key in shapes:
            shapes[key]["count"] += 1
            continue
        shapes[key] = {
            "node": node.name or node.outputs[0], "count": 1,
            "a": a.reshape(key[0], key[1]).contiguous(), "b": b,
            "mult": (_const(qgraph, params, node.inputs[1]).float()
                     * _const(qgraph, params, node.inputs[4]).float()
                     / _const(qgraph, params, node.inputs[6]).float()),
            "bias": params.get(node.inputs[8]) if len(node.inputs) > 8
            else None,
            "out": card[node.outputs[0]].reshape(key[0], key[2]),
            "packed": eng8.packed.get(node.inputs[3])}
    return shapes


def phase_kernels(qgraph, eng8, card, launches: int, smi: str) -> dict:
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels.qconv_int8 import (
        conv_input, conv_plan, qconv_int8_requant, qconv_int8_requant_plain,
        s2d_conv, space_to_depth_plain)

    shapes = _qconv_shapes(qgraph, eng8, card, grouped=False)

    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                         "library_ms", "ms_1x1", "copy_ms"), 0.0)
    max_err = 0
    for (xs, ws, stride, padding), s in shapes.items():
        w, mult, bias = s["w"], s["mult"], s["bias"]
        x_main = s["x"]  # as the main path hands it over
        x = x_main.contiguous(memory_format=torch.channels_last)

        def kern():
            return qconv_int8_requant(x, w, mult, bias, stride=stride,
                                      padding=padding, packed=s["packed"])

        def plain():
            return qconv_int8_requant_plain(x, w, mult, bias, stride=stride,
                                            padding=padding)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        require(torch.equal(got, want), f"kernel == plain at {s['node']} "
                f"x{xs} w{ws} (max |diff| {err})")
        require(got.is_contiguous(memory_format=torch.channels_last),
                f"channels-last output at {s['node']}")
        ms, ms_eager = graph_ms(kern, ITERS), cuda_ms(kern, ITERS)
        plain_ms = cuda_ms(plain, 3)
        # the layout pass the wrapper makes of the main path's own input
        # (conv1's: its space-to-depth rewrite), timed alone
        def layout():
            return conv_input(x_main, ws, stride, padding)

        copies = layout().data_ptr() != x_main.data_ptr()
        copy_ms = graph_ms(layout, ITERS) if copies else 0.0
        geo = s2d_conv(xs, ws, stride, padding)
        if geo is not None:  # the layout kernel against its plain version
            require(torch.equal(layout(), space_to_depth_plain(x_main, geo)),
                    f"space-to-depth layout kernel == plain at {s['node']}")
        library_ms = None
        if ws[2:] == (1, 1) and stride == (1, 1) and not any(
                sum(padding, ())):
            # one PyTorch call with the same contraction (int32 out, no
            # epilogue), on the same channels-last data, timed the same way
            a = x.permute(0, 2, 3, 1).reshape(-1, xs[1])
            b = w.reshape(ws[0], ws[1])
            library_ms = graph_ms(lambda: torch._int_mm(a, b.t()), ITERS)
        ops, nbytes = _conv_work(x, w, stride, padding)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     INT8_OPS_PER_S)
        producer, tile = conv_plan(xs, ws, stride, padding)
        emit({"phase": "kernel", "kernel": "qconv_int8_requant",
              "node": s["node"], "x": list(xs), "w": list(ws),
              "stride": list(stride), "padding": [list(p) for p in padding],
              "producer": producer, "tile": list(tile),
              "count_per_forward": s["count"],
              # 26 QLinearConvs per forward (phase_slice checks it)
              "launches": s["count"] * (launches // 26), "equal": True,
              "max_abs_err": err, "ms": ms, "ms_eager": ms_eager,
              "layout_copy_ms": copy_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "ops": ops, "bytes": nbytes,
              "tops": ops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6})
        n = s["count"]
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("copy_ms", copy_ms)):
            tot[k] += n * v
        if library_ms is not None:
            tot["library_ms"] += n * library_ms
            tot["ms_1x1"] += n * ms

    require(launches > 0, "qconv_int8_requant launched on the main path")
    source, replaces = KERNEL_ROWS["qconv_int8_requant"]
    return {
        "name": "qconv_int8_requant", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": tot["library_ms"],
        "ms_same_shapes_as_library": tot["ms_1x1"],
        "layout_copy_ms": tot["copy_ms"],
        "per": "one INT8 SqueezeNet 1.0 forward at b256: ms, plain_ms and "
               "bound_ms sum its 26 QLinearConvs; ms is the wrapper's device "
               "time (CUDA-graph replay) on channels-last input, as the "
               "previous conv leaves it (conv1's includes its space-to-depth "
               "layout pass); layout_copy_ms sums the layout passes the "
               "wrapper makes of the main path's own inputs (conv1's NCHW "
               "input as its space-to-depth rewrite), timed alone; "
               "library_ms sums torch._int_mm (int32 "
               "out, no epilogue, timed the same way) over the 1x1 convs "
               "only, as no PyTorch call computes an int8 kxk conv, and "
               "ms_same_shapes_as_library is the kernel's own sum over "
               "those same 1x1 convs; plain_ms is eager",
        "distinct_shapes": len(shapes), "card": smi}


# --------------------------------------------------------------------------
# GPT-2 decode
# --------------------------------------------------------------------------
def _decode_prompts(cfg) -> np.ndarray:
    return np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (DEC_BATCH, PROMPT))


def _generator(cfg, **kw):
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator

    return Generator(cfg, batch=DEC_BATCH, prompt_len=PROMPT,
                     max_len=MAX_LEN, **kw)


def _decode_tokens_per_s(gen, prompts, **kw) -> dict:
    """Decode tokens/s of gen.generate(prompts, n, **kw): the time of a
    NEW-token run less that of a 1-token run (prefill and first pick), by
    the host clock around synchronized runs and by CUDA events; warmed
    first."""
    def timed(n_new):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        gen.generate(prompts, n_new, **kw)
        end.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, start.elapsed_time(end) / 1e3

    gen.generate(prompts, NEW, **kw)
    full_wall, full_ev = timed(NEW)
    pre_wall, pre_ev = timed(1)
    toks = DEC_BATCH * (NEW - 1)
    return {"wall_s": full_wall - pre_wall, "events_s": full_ev - pre_ev,
            "tokens_per_s_wall": toks / (full_wall - pre_wall),
            "tokens_per_s_events": toks / (full_ev - pre_ev),
            "prefill_s_wall": pre_wall}


def _plain_rerun(gen, prompts, toks, same_cache: bool = False):
    """The prefill and the first CPU_STEPS steps of gen's main path through
    the plain versions on the CPU, fed the card's tokens and KV scales:
    (relative logit errors, greedy agreements) per pass; raises past
    1e-2 * max|logit|. same_cache: each CPU step also takes the card's
    cache as it stands before that step (the same inputs on both devices),
    as an INT4 KV cache needs: a 1e-7 difference in a new K/V value moves
    its 4-bit code by one step (1/7 of the head's range) now and then, and
    two caches built apart drift by that much. The errors of the CPU's own
    cache are then returned third, for information."""
    cpu = gen.to("cpu")
    card_logits, card_cache = gen.start(prompts)
    host_logits, host_cache = cpu.start(prompts)
    require(bool(torch.isfinite(card_logits).all()), "finite prefill logits")
    errs, agree, own = [], [], []

    def rel(card_l, host_l):
        c, h = card_l[:, -1].cpu(), host_l[:, -1]
        return float((c - h).abs().max() / h.abs().max())

    def compare(card_l, host_l, want_tok):
        errs.append(rel(card_l, host_l))
        h = host_l[:, -1]
        agree.append(float((h.argmax(-1).numpy() == want_tok).mean()))
        require(bool((card_l[:, -1].cpu().argmax(-1).numpy()
                      == want_tok).all()),
                "the card's teacher-forced step repeats its own tokens")

    compare(card_logits, host_logits, toks[:, 0])
    for t in range(CPU_STEPS):
        tok = torch.from_numpy(toks[:, t])
        if same_cache:
            shared = {k: v.cpu() for k, v in card_cache.items()}
            host_l, _ = cpu.step(shared, tok, PROMPT + t)
            own_l, host_cache = cpu.step(host_cache, tok, PROMPT + t)
        card_l, card_cache = gen.step(card_cache, tok.cuda(), PROMPT + t)
        if same_cache:
            own.append(rel(card_l, own_l))
        else:
            host_l, host_cache = cpu.step(host_cache, tok, PROMPT + t)
        compare(card_l, host_l, toks[:, t + 1])
    require(max(errs) <= 1e-2, f"card vs plain logits: {errs}")
    return (errs, agree, own) if same_cache else (errs, agree)


def matmul_nbits_nodes(graph):
    """(MatMulNBits node, launches per pass of the graph) over the graph
    and the bodies of its Scan nodes, which launch theirs once per
    iteration (the trip count: a stacked scan input's leading dim)."""
    out = []
    for node in graph.nodes:
        if node.op_type == "MatMulNBits":
            out.append((node, 1))
        elif node.op_type == "Scan":
            from onnx_rusty_inference_engine_tpu_torch.graph import (
                _node_from_proto)

            n_state = len(node.inputs) - int(node.attr("num_scan_inputs"))
            trips = graph.constants[node.inputs[n_state]].shape[0]
            out += [(_node_from_proto(b), trips)
                    for b in node.attr("body").nodes
                    if b.op_type == "MatMulNBits"]
    return out


def _int4_picks(gen, name: str, m_prefill: int, m_step: int,
                steps: int) -> dict:
    """Launches per schedule that qmatmul_int4.int4_schedule picks for the
    MatMulNBits nodes of gen's main path: its prefill graph once at
    M = m_prefill and its decode graph `steps` times at M = m_step (a
    Scan body's nodes once per iteration). `name` says the layout:
    qmatmul_int4_planar (planar_layout of K and block_size) or
    qmatmul_int4_bf16 (interleaved, nb blocks of the scales)."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)

    picks = dict.fromkeys(q4.SCHEDULES, 0)
    for graph, M, passes in ((gen.prefill.graph, m_prefill, 1),
                             (gen.decode.graph, m_step, steps)):
        for node, reps in matmul_nbits_nodes(graph):
            K = int(node.attr("K"))
            if name == "qmatmul_int4_planar":
                nblk, blk = q4.planar_layout(K, int(node.attr("block_size")))
            else:
                nblk = graph.constants[node.inputs[2]].shape[1]
                blk = K // 2 // nblk
            picks[q4.int4_schedule(M, K, nblk, blk)] += passes * reps
    return picks


def _int4_schedules(gen, name: str, steps: int) -> dict:
    """The schedules int4 kernel `name` ran on over the main path just
    driven, each launch held to int4_schedule's pick for its shape."""
    got = dict(_wrappers()[name].schedules)
    want = _int4_picks(gen, name, DEC_BATCH * PROMPT, DEC_BATCH, steps)
    require(got == want, f"{name}: every launch on int4_schedule's pick "
                         f"{want}, got {got}")
    return got


def phase_decode():
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config()  # SMALL: GPT-2 124M at its published widths
    prompts = _decode_prompts(cfg)
    t0 = time.perf_counter()
    gen = _generator(cfg, kv_dtype="int8", int4_weights=True,
                     fused_attention=True)
    build_s = time.perf_counter() - t0
    n4_pre = sum(n.op_type == "MatMulNBits" for n in gen.prefill.graph.nodes)
    n4_dec = sum(n.op_type == "MatMulNBits" for n in gen.decode.graph.nodes)
    n_attn = sum(n.op_type == "FusedDecodeAttention"
                 for n in gen.decode.graph.nodes)
    require(n4_pre == n4_dec == 4 * cfg.n_layer + 1 and n_attn == cfg.n_layer,
            f"49 MatMulNBits per graph and 12 fused attentions: {n4_pre}, "
            f"{n4_dec}, {n_attn}")

    # the main path
    reset_counts()
    t0 = time.perf_counter()
    toks, _ = gen.generate(prompts, NEW)
    counts = read_counts()
    main_s = time.perf_counter() - t0
    steps = NEW - 1
    require(counts["qmatmul_int4_planar"] == n4_pre + n4_dec * steps,
            f"49 int4 launches per prefill and per step: {counts}")
    schedules = _int4_schedules(gen, "qmatmul_int4_planar", steps)
    require(schedules == {"general": 0, "small_m": n4_dec * steps,
                          "mma": n4_pre},
            f"GPT-2: every prefill launch on mma, every step launch on "
            f"small_m: {schedules}")
    require(counts["decode_attention_int8"] == n_attn * steps,
            f"12 attention launches per step: {counts}")
    require(counts["decode_attention_int8_mxu"] == 0
            and counts["qconv_int8_requant"] == 0
            and counts["qmatmul_int8"] == counts["qmatmul_int4_bf16"] == 0,
            f"counts {counts}")
    require(toks.shape == (DEC_BATCH, NEW) and toks.min() >= 0
            and toks.max() < cfg.vocab_size, f"tokens {toks.shape}")
    errs, agree = _plain_rerun(gen, prompts, toks)

    # the int8 x int8 attention path (ORIET_ATTN_I8), its own counts
    os.environ["ORIET_ATTN_I8"] = "1"
    try:
        reset_counts()
        toks_i8, _ = gen.generate(prompts, NEW)
        counts_i8 = read_counts()
        tps_mxu = _decode_tokens_per_s(gen, prompts)
    finally:
        del os.environ["ORIET_ATTN_I8"]
    require(counts_i8["decode_attention_int8_mxu"] == n_attn * steps
            and counts_i8["decode_attention_int8"] == 0
            and counts_i8["qmatmul_int4_planar"] == n4_pre + n4_dec * steps,
            f"ORIET_ATTN_I8 path counts: {counts_i8}")

    tps = {"int4_int8kv_fused": _decode_tokens_per_s(gen, prompts),
           "int4_int8kv_fused_i8attn": tps_mxu}
    for name, kw in (("fp32_fp32kv", {}),
                     ("int4_int8kv_unfused", {"kv_dtype": "int8",
                                              "int4_weights": True})):
        other = _generator(cfg, **kw)
        tps[name] = _decode_tokens_per_s(other, prompts)
        del other
        torch.cuda.empty_cache()

    emit({"phase": "decode", "model": "gpt2 124M (SMALL, seed 0)",
          "batch": DEC_BATCH, "prompt": PROMPT, "max_len": MAX_LEN,
          "new_tokens": NEW, "build_s": build_s, "main_path_s": main_s,
          "launches": counts, "launches_i8attn": counts_i8,
          "int4_schedules": schedules,
          "int4_per_prefill": n4_pre, "int4_per_step": n4_dec,
          "attention_per_step": n_attn,
          "card_vs_plain_rel_err": errs,
          "plain_greedy_agreement": agree,
          "i8attn_token_agreement": float((toks_i8 == toks).mean()),
          "decode_tokens_per_s": tps,
          "tokens_row0": toks[0, :16].tolist()})
    return gen, prompts, counts, counts_i8, toks, toks_i8


# device kernel name fragment -> bucket, first match wins
_DEC_BUCKETS = (("int4_", "qmatmul_int4 (int4 matmul)"),  # every schedule
                ("decode_attn", "decode attention"),
                ("gemm", "other matmul"), ("softmax", "softmax"),
                ("reduce", "reductions (LayerNorm)"),
                ("elementwise", "elementwise / copies"),
                ("copy", "elementwise / copies"),
                ("index", "gather / index"))


def phase_decode_profile(gen, prompts, reps: int = 5, *,
                         engine: str = "gpt2 decode step (int4, int8 KV, "
                                       "fused)") -> dict:
    """One decode step of gen under torch.profiler: wall against device
    busy time, by kernel and by bucket. Returns the emitted line."""
    from torch.profiler import ProfilerActivity, profile

    _, cache = gen.start(prompts)
    tok = torch.zeros((DEC_BATCH,), dtype=torch.int64, device=gen.device)
    with torch.no_grad():
        gen.step(cache, tok, PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            gen.step(cache, tok, PROMPT)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                gen.step(cache, tok, PROMPT)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels, launches = {}, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3 / reps
        launches += evt.count
    buckets = {}
    for kname, ms in kernels.items():
        b = next((label for frag, label in _DEC_BUCKETS if frag in kname),
                 "other")
        buckets[b] = buckets.get(b, 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    # PyTorch's copy kernels, and its concatenations (a Scan's stacked
    # outputs), per step
    cuda_evts = [evt for evt in prof.key_averages()
                 if evt.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(evt.count for evt in cuda_evts if "copy" in evt.key.lower()
                 and "CatArray" not in evt.key) / reps
    cats = sum(evt.count for evt in cuda_evts if "CatArray" in evt.key) / reps
    line = {"phase": "profile", "engine": engine, "batch": DEC_BATCH,
            "pos": PROMPT, "wall_ms_per_step": plain_wall_ms,
            "wall_ms_per_step_profiled": wall_ms,
            "device_busy_ms_per_step": busy,
            "device_idle_share": (1 - busy / wall_ms) if busy else None,
            "device_ops_per_step": launches / reps,
            "copy_kernels_per_step": copies,
            "concat_kernels_per_step": cats,
            "buckets_ms": dict(sorted(buckets.items(),
                                      key=lambda kv: -kv[1])),
            "busy_share_by_bucket": {k: v / busy for k, v in buckets.items()}
            if busy else None,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}
    emit(line)
    return line


def _int4_library(a, q, scales_k, bs):
    """(label, fn) of one PyTorch call computing the same int4 product:
    torch._weight_int4pack_mm (bf16, groupsize bs) where this PyTorch takes
    the weight, else a bf16 matmul on the weight dequantized beforehand.
    q: int32 [Nw, K], the weight's values + 8 in k order; scales_k: f32
    [K/bs, Nw], the scale of each group of bs consecutive k. Nw is rounded
    up to a multiple of 64 with zero columns, as the library packs whole
    column tiles; the caller keeps the first N."""
    pad = -q.shape[0] % 64
    q = torch.nn.functional.pad(q, (0, 0, 0, pad), value=8)
    scales_k = torch.nn.functional.pad(scales_k, (0, pad))
    ab = a.to(torch.bfloat16)
    sz = torch.stack([scales_k, torch.zeros_like(scales_k)], dim=-1)
    sz = sz.contiguous().to(torch.bfloat16)              # [K/bs, Nw, 2]
    for weight in ((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8),  # >= 2.5
                   q):                                           # older
        for tiles in (8, 4, 2):
            try:
                wp = torch._convert_weight_to_int4pack(weight.contiguous(),
                                                       tiles)
                torch._weight_int4pack_mm(ab, wp, bs, sz)
                torch.cuda.synchronize()
            except Exception:  # this PyTorch takes another weight form
                continue
            return ("torch._weight_int4pack_mm (bf16, groupsize bs, Nw "
                    "rounded up to 64 columns)",
                    lambda wp=wp: torch._weight_int4pack_mm(ab, wp, bs, sz))
    scale_k = scales_k.t().repeat_interleave(bs, dim=1)    # [Nw, K]
    w = ((q - 8).float() * scale_k).t().contiguous().to(torch.bfloat16)
    return ("torch.matmul bf16 on the weight dequantized beforehand",
            lambda: torch.matmul(ab, w))


def decode_int4_weights(gen) -> list:
    """(MatMulNBits node, packed weight, scales, launches per pass) of
    gen's decode graph on the card: a Scan body's nodes with layer 0's
    slice of their stacked weights (a view, as the Scan hands each
    iteration) and one launch per layer."""
    params, out = gen.decode.params, []
    for node in gen.decode.graph.nodes:
        if node.op_type == "MatMulNBits":
            out.append((node, params[node.inputs[1]],
                        params[node.inputs[2]], 1))
    scans = [n for n in gen.decode.graph.nodes if n.op_type == "Scan"]
    for scan in scans:
        outer = dict(zip((vi.name for vi in scan.attr("body").inputs),
                         scan.inputs))
        for node, reps in matmul_nbits_nodes(gen.decode.graph):
            if node.inputs[1] in outer:
                out.append((node, params[outer[node.inputs[1]]][0],
                            params[outer[node.inputs[2]]][0], reps))
    return out


GPT2_INT4_PER = ("one GPT-2 124M decode step at batch 8: the sum over its 49 "
                 "launches (4 per layer + the lm_head)")


def int4_kernel_row(gen, name: str, launches: int, smi: str,
                    per: str = GPT2_INT4_PER) -> dict:
    """The kernel lines of int4 kernel `name` (qmatmul_int4_planar or
    qmatmul_int4_bf16, by the layout of gen's MatMulNBits weights): each
    distinct (M, K, N) of the prefill (M = batch * prompt) and of a decode
    step (M = batch), on the decode graph's own weights; and its row of the
    kernels line, summed over one decode step."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)

    kern_fn, plain_fn = getattr(q4, name), getattr(q4, name + "_plain")
    planar = name == "qmatmul_int4_planar"
    rng = np.random.default_rng(1)
    shapes = {}
    for node, packed, scales, reps in decode_int4_weights(gen):
        K, N = int(node.attr("K")), int(node.attr("N"))
        for M, phase in ((DEC_BATCH * PROMPT, "prefill"),
                         (DEC_BATCH, "step")):
            key = (M, K, N)
            if key in shapes:
                shapes[key]["count"] += reps
                continue
            shapes[key] = {"count": reps, "phase": phase,
                           "node": node.inputs[1],
                           "bs": int(node.attr("block_size")),
                           "packed": packed, "scales": scales}
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "ops_ms": 0.0, "bytes_ms": 0.0}
    pre = dict(step)
    max_abs, max_rel = 0.0, 0.0
    passes = {"prefill": 1, "step": NEW - 1}  # of the main path
    sched_seen = {"prefill": set(), "step": set()}
    require(sum(sh["count"] * passes[sh["phase"]] for sh in shapes.values())
            == launches, f"the {name} shapes account for every main-path "
            f"launch")
    for (M, K, N), sh in shapes.items():
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).cuda()
        packed, scales, bs = sh["packed"], sh["scales"], sh["bs"]
        Nw = packed.shape[0]
        p = packed.to(torch.int32)
        if planar:  # scales [2 * nbh, Nw], k-major
            kw = {"qblock": bs, "n": N}
            layout = {"bs": bs, "nbh": scales.shape[0] // 2}
            nblk, blk = q4.planar_layout(K, bs)
            q = torch.cat([p & 0xF, p >> 4], dim=1)
            scales_k = scales
        else:  # scales [Nw, nb], n-major
            kw = {"n": N}
            layout = {"qblock": bs, "nb": scales.shape[1]}
            nblk, blk = scales.shape[1], K // 2 // scales.shape[1]
            q = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(Nw, K)
            scales_k = scales.t()
        schedule = q4.int4_schedule(M, K, nblk, blk)
        sched_seen[sh["phase"]].add(schedule)

        def kern():
            return kern_fn(a, packed, scales, **kw)

        def plain():
            return plain_fn(a, packed, scales, **kw)

        before = dict(kern_fn.schedules)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        require(kern_fn.schedules[schedule] == before[schedule] + 1,
                f"{name} at M={M} K={K} N={N} launched on {schedule}")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
        require(rel <= 1e-5, f"{name} vs plain at M={M} K={K} N={N}: {rel}")
        ms, ms_eager = graph_ms(kern, DEC_ITERS), cuda_ms(kern, DEC_ITERS)
        plain_ms = cuda_ms(plain, 3)
        lib_label, lib = _int4_library(a, q, scales_k, bs)
        lib_out = lib()[:, :N].float()
        lib_rel = float((lib_out - want).abs().max() / want.abs().max())
        library_ms = graph_ms(lib, DEC_ITERS)
        ops = 2 * M * N * K
        nbytes = (M * K * 4 + N * K // 2 + scales.numel() // Nw * N * 4
                  + M * N * 4)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     BF16_OPS_PER_S)
        emit({"phase": "kernel", "kernel": name,
              "node": sh["node"], "M": M, "K": K, "N": N, "Nw": Nw,
              **layout, "where": sh["phase"], "schedule": schedule,
              "count_per_" + sh["phase"]: sh["count"],
              "launches": sh["count"] * passes[sh["phase"]],
              "max_abs_err": err, "max_rel_err": rel, "ms": ms,
              "ms_eager": ms_eager, "host_ms_per_call": ms_eager - ms,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library": lib_label, "library_max_rel_err": lib_rel,
              "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
              "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
              "tflops": ops / ms / 1e9})
        n = sh["count"]
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("library_ms", library_ms),
                     ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            (step if sh["phase"] == "step" else pre)[k] += n * v
    source, replaces = KERNEL_ROWS[name]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max_abs, "max_rel_err": max_rel, "ms": step["ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": ("operations" if step["ops_ms"] >= step["bytes_ms"]
                     else "bytes"),
        "library_ms": step["library_ms"],
        "schedules": {k: sorted(v) for k, v in sched_seen.items()},
        "prefill_ms": pre["ms"], "prefill_library_ms": pre["library_ms"],
        "per": per + "; the prefill shapes "
               "are in the kernel lines, prefill_ms and prefill_library_ms "
               "their sums over one prefill. ms and library_ms are device "
               "times (CUDA-graph replay); plain_ms is eager. library_ms: "
               "the same sum of the library calls named in the kernel lines",
        "distinct_shapes": len(shapes), "card": smi}


SWEEP_M = (1, 8, 16, 32, 64, 128, 512)
SWEEP_K, SWEEP_N = 768, 2304   # GPT-2 124M's qkv projection


def phase_int4_sweep(smi: str) -> None:
    """Both int4 kernels over M at K = 768, N = 2304 on a weight from seed
    2 (block 256): every schedule that takes the shape, held to the plain
    version (1e-5 x max|out|) and timed by CUDA-graph replay, beside the
    library call; the schedule int4_schedule picks. Where small_m stops
    beating mma is the crossover that qmatmul_int4.SMALL_M_MAX records."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)
    from onnx_rusty_inference_engine_tpu_torch.quant import (
        pack_int4, pack_int4_planar)

    rng = np.random.default_rng(2)
    w = rng.standard_normal((SWEEP_K, SWEEP_N)).astype(np.float32)
    rows, wins = [], {}
    for layout in ("planar", "interleaved"):
        if layout == "planar":
            packed, scales = pack_int4_planar(w, 256)
            wrapper, plain_fn = (q4.qmatmul_int4_planar,
                                 q4.qmatmul_int4_planar_plain)
            nblk, blk = q4.planar_layout(SWEEP_K, 256)
            kw, group = {"qblock": 256}, blk
        else:
            packed, scales = pack_int4(w, 256)
            wrapper, plain_fn = (q4.qmatmul_int4_bf16,
                                 q4.qmatmul_int4_bf16_plain)
            nblk = scales.shape[1]
            blk, kw, group = SWEEP_K // 2 // nblk, {}, 256
        packed, scales = (torch.from_numpy(x).cuda() for x in (packed, scales))
        p = packed.to(torch.int32)
        if layout == "planar":
            q, scales_k = torch.cat([p & 0xF, p >> 4], dim=1), scales
        else:
            q = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(-1, SWEEP_K)
            scales_k = scales.t()
        for M in SWEEP_M:
            a = torch.from_numpy(rng.standard_normal((M, SWEEP_K)).astype(
                np.float32)).cuda()
            want = plain_fn(a, packed, scales, **kw)
            ms = {}
            for sched in q4.SCHEDULES:
                if sched == "small_m" and M > 16:  # the kernel's own limit
                    continue

                def fn(sched=sched):  # the wrapper's launch, schedule forced
                    return q4._launch(wrapper, a, packed, scales, SWEEP_N,
                                      nblk, blk, sched)

                got = fn()
                torch.cuda.synchronize()
                rel = float((got - want).abs().max() / want.abs().max())
                require(rel <= 1e-5, f"{layout} {sched} at M={M}: {rel}")
                ms[sched] = graph_ms(fn, DEC_ITERS)
            _, lib = _int4_library(a, q, scales_k, group)
            rows.append({"layout": layout, "M": M,
                         "picked": q4.int4_schedule(M, SWEEP_K, nblk, blk),
                         "ms": ms, "library_ms": graph_ms(lib, DEC_ITERS)})
            if "small_m" in ms:
                wins.setdefault(M, []).append(ms["small_m"] < ms["mma"])
    crossover = max([M for M, w in wins.items() if all(w)], default=0)
    emit({"phase": "int4_m_sweep", "K": SWEEP_K, "N": SWEEP_N,
          "block": 256, "rows": rows,
          "crossover_measured": crossover,
          "small_m_max": q4.SMALL_M_MAX,
          "note": "ms by schedule: device ms per call (CUDA-graph replay); "
                  "crossover_measured: the largest swept M at which small_m "
                  "beats mma in both layouts",
          "card": smi})


def phase_decode_kernels(gen, prompts, counts, counts_i8, smi: str):
    rng = np.random.default_rng(1)
    rows = [int4_kernel_row(gen, "qmatmul_int4_planar",
                            counts["qmatmul_int4_planar"], smi)]

    # attention: the decode step's one shape, on the prefill's real cache
    _, cache = gen.start(prompts)
    H, hd = gen.cfg.n_head, gen.cfg.head_dim
    k8 = cache["past_key_0"].reshape(DEC_BATCH * H, MAX_LEN, hd)
    v8 = cache["past_value_0"].reshape(DEC_BATCH * H, MAX_LEN, hd)
    q = torch.from_numpy((rng.standard_normal((DEC_BATCH * H, 1, hd))
                          / (127 * np.sqrt(hd))).astype(np.float32)).cuda()
    valid = np.arange(MAX_LEN) <= PROMPT  # the first step, at pos = prompt
    bias = torch.from_numpy(np.broadcast_to(
        np.where(valid, 0.0, -1e9).astype(np.float32),
        (DEC_BATCH, 1, MAX_LEN)).copy()).cuda()
    n_valid = int(valid.sum())
    for name, launches in (
            ("decode_attention_int8", counts["decode_attention_int8"]),
            ("decode_attention_int8_mxu",
             counts_i8["decode_attention_int8_mxu"])):
        line = attn_measure(name, q, k8, v8, bias, H, n_valid, plain=True)
        emit({"phase": "kernel", "kernel": name, "q": [DEC_BATCH * H, 1, hd],
              "kv": [DEC_BATCH * H, MAX_LEN, hd], "valid_positions": n_valid,
              "count_per_step": gen.cfg.n_layer, "launches": launches,
              **line, "card": smi})
        source, replaces = KERNEL_ROWS[name]
        n = gen.cfg.n_layer
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": line["max_abs_err"],
            "max_rel_err": line["max_rel_err"], "ms": n * line["ms"],
            "plain_ms": n * line["plain_ms"],
            "bound_ms": n * line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": n * line["library_ms"],
            "cluster": line["cluster"], "rows_read": line["rows_read"],
            "per": "one GPT-2 124M decode step at batch 8, pos 64: 12 "
                   "launches (one per layer); ms and library_ms are device "
                   "times (CUDA-graph replay), plain_ms eager; launches "
                   "counted on "
                   + ("the main path" if name == "decode_attention_int8"
                      else "the ORIET_ATTN_I8=1 run of the same path"),
            "card": smi})
    return rows


ATTN_FORMS = {  # kernel -> (plain version, tolerance x max|out|, peak)
    "decode_attention_int8": ("decode_attention_int8_plain", 1e-5,
                              BF16_OPS_PER_S),
    "decode_attention_int8_mxu": ("decode_attention_int8_mxu_plain", 1e-2,
                                  INT8_OPS_PER_S)}
L2_BYTES = 50e6  # the H100's L2 cache


def _sdpa_bf16(q, k8, v8, bias, H):
    """One PyTorch call computing the same attention: F.scaled_dot_product_
    attention in bf16 on K/V dequantized beforehand (GQA by enable_gqa).
    Timed only; the port never calls it."""
    import torch.nn.functional as F

    B, L, hd = bias.shape[0], bias.shape[-1], q.shape[-1]
    Hkv = k8.shape[0] // B
    qb = q.reshape(B, H, 1, hd).to(torch.bfloat16)
    kb = k8.reshape(B, Hkv, L, hd).to(torch.bfloat16)
    vb = v8.reshape(B, Hkv, L, hd).to(torch.bfloat16)
    mb = bias.reshape(B, 1, 1, L).to(torch.bfloat16)
    gqa = {"enable_gqa": True} if Hkv != H else {}
    return lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mb,
                                                  scale=1.0, **gqa)


def _graph_ms_cold(make, nbytes: int) -> float:
    """graph_ms of calls that cycle through copies of the operands
    (make(i) -> fn on copy i) that together exceed twice the L2 cache, so
    that each call finds its operands in device memory, as a decode step
    finds a layer's cache after the other layers' weights and caches."""
    n = int(min(DEC_ITERS, max(2, -(-2 * L2_BYTES // max(nbytes, 1)))))
    fns = [make(i) for i in range(n)]
    turn = [0]

    def fn():
        turn[0] += 1
        return fns[turn[0] % n]()

    return graph_ms(fn, DEC_ITERS)


def attn_measure(name, q, k8, v8, bias, H, n_valid, *, plain=False) -> dict:
    """One attention kernel on (q, k8, v8, bias) with n_valid valid cache
    rows per batch row: held to its plain version on the card (raises past
    its tolerance), its K rows counted by the kernel against
    attn_live_chunks, and timed by CUDA-graph replay with the cache hot in
    L2 (ms) and cold (ms_cold), beside SDPA bf16 (library_ms, timed alike)
    and the card's bound for what the data needs (the valid rows' K and V,
    q, bias, out). bytes_read: what the kernel moves (the rows it loads,
    the bias row once per CTA, q, out)."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        decode_attn as da)

    plain_name, tol, peak = ATTN_FORMS[name]
    kern, plain_fn = getattr(da, name), getattr(da, plain_name)
    B, L, hd = bias.shape[0], bias.shape[-1], q.shape[-1]
    Hkv = k8.shape[0] // B
    C = da.attn_split(B, H, Hkv, L, hd)
    counter = torch.zeros(1, dtype=torch.int32, device=q.device)
    got = da._launch(name, q, k8, v8, bias, H, rows_read=counter)
    want = plain_fn(q, k8, v8, bias, n_q_heads=H)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    require(rel <= tol, f"{name} vs plain at {(B, H, Hkv, L, hd)}: {rel} "
                        f"(tolerance {tol})")
    rows_read = int(da.attn_live_chunks(
        q, bias, n_q_heads=H, n_kv_heads=Hkv,
        mxu=name.endswith("_mxu")).sum())
    require(int(counter.item()) == rows_read,
            f"{name}: the kernel loaded {int(counter.item())} K rows, "
            f"attn_live_chunks says {rows_read}")
    sdpa = _sdpa_bf16(q, k8, v8, bias, H)
    lib_rel = float((sdpa().reshape(want.shape).float() - want).abs().max()
                    / want.abs().max())

    def kern_fn():
        return kern(q, k8, v8, bias, n_q_heads=H)

    def kern_on(i):
        if i == 0:
            return kern_fn
        kc, vc = k8.clone(), v8.clone()
        return lambda: kern(q, kc, vc, bias, n_q_heads=H)

    def sdpa_on(i):
        return sdpa if i == 0 else _sdpa_bf16(q, k8.clone(), v8.clone(),
                                              bias, H)

    kv_bytes = 2 * k8.numel()
    line = {"cluster": C, "ms": graph_ms(kern_fn, DEC_ITERS),
            "ms_cold": _graph_ms_cold(kern_on, kv_bytes),
            "library_ms": graph_ms(sdpa, DEC_ITERS),
            "library_ms_cold": _graph_ms_cold(sdpa_on, 2 * kv_bytes)}
    if plain:
        line["ms_eager"] = cuda_ms(kern_fn, DEC_ITERS)
        line["plain_ms"] = cuda_ms(lambda: plain_fn(q, k8, v8, bias,
                                                    n_q_heads=H), 3)
    ops = 4 * B * H * n_valid * hd
    nbytes = B * H * hd * 4 * 2 + 2 * B * Hkv * n_valid * hd + B * L * 4
    bound_ms, bound_by, _, _ = bound(ops, nbytes, peak)
    bytes_read = 2 * rows_read * hd + B * Hkv * C * L * 4 + B * H * hd * 8
    line.update({
        "max_abs_err": err, "max_rel_err": rel, "tolerance": tol,
        "library": "F.scaled_dot_product_attention, bf16, on K/V "
                   "dequantized beforehand",
        "library_max_rel_err": lib_rel, "bound_ms": bound_ms,
        "bound_by": bound_by, "ops": ops, "bytes": nbytes,
        "rows_read": rows_read, "rows_total": B * Hkv * L,
        "bytes_read": bytes_read,
        "gb_per_s": nbytes / line["ms"] / 1e6,
        "gb_per_s_read": bytes_read / line["ms"] / 1e6})
    return line


# (label, B, H, Hkv, hd, L, valid rows per batch row)
ATTN_SWEEP = (("main_first_step", 8, 12, 12, 64, 256, 65),
              ("main_last_step", 8, 12, 12, 64, 256, 128),
              ("full_context", 8, 12, 12, 64, 1024, 1024),
              ("batch1_full_context", 1, 12, 12, 64, 1024, 1024),
              ("long_cache_mostly_empty", 8, 12, 12, 64, 1024, 257),
              ("gqa_rep4_hd128", 8, 32, 8, 128, 1024, 1024))


def phase_attn_sweep(smi: str) -> None:
    """Both attention kernels at the ATTN_SWEEP shapes, on data from seed
    3 (q scaled as the decode graph scales it, the int8 cache uniform in
    [-127, 127], the first `valid` rows of every batch row unmasked): one
    attn_measure line per shape and kernel."""
    rng = np.random.default_rng(3)
    for label, B, H, Hkv, hd, L, n_valid in ATTN_SWEEP:
        q = torch.from_numpy((rng.standard_normal((B * H, 1, hd))
                              / (127 * np.sqrt(hd))).astype(np.float32)).cuda()
        k8, v8 = (torch.from_numpy(rng.integers(
            -127, 128, (B * Hkv, L, hd), dtype=np.int8)).cuda()
            for _ in range(2))
        bias = torch.from_numpy(np.broadcast_to(
            np.where(np.arange(L) < n_valid, 0.0, -1e9).astype(np.float32),
            (B, 1, L)).copy()).cuda()
        for name in ATTN_FORMS:
            emit({"phase": "attn_sweep", "shape": label, "kernel": name,
                  "B": B, "H": H, "Hkv": Hkv, "hd": hd, "L": L,
                  "valid_rows": n_valid,
                  **attn_measure(name, q, k8, v8, bias, H, n_valid),
                  "card": smi})
        del q, k8, v8, bias
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# GPT-2 decode with ORT-layout (interleaved) int4 weights
# --------------------------------------------------------------------------
def ort_int4_weights(graph):
    """`graph` with every MatMul that quant.quantize_weights_int4 would take
    (at its defaults: at least 4096 weights, block 256) rewritten into the
    form an ORT-quantized model carries: MatMulNBits(K, N, bits=4,
    block_size) in domain com.microsoft with no `layout` attribute, fed
    quant.pack_int4's interleaved packed [N, K/2] and scales [N, K/block].
    Neither package's quantizer emits this form; the tests import it from
    here."""
    from onnx_rusty_inference_engine_tpu_torch.graph import (
        Graph, Node, prune_dead)
    from onnx_rusty_inference_engine_tpu_torch.quant import pack_int4

    nodes, consts = [], dict(graph.constants)
    weights = list(graph.weight_names)
    for n in graph.nodes:
        w = (consts.get(n.inputs[1])
             if n.op_type == "MatMul" and len(n.inputs) == 2 else None)
        if (w is None or w.ndim != 2 or w.size < 4096
                or not np.issubdtype(w.dtype, np.floating) or w.shape[0] % 2):
            nodes.append(n)
            continue
        K, N = w.shape
        packed, scales = pack_int4(w.astype(np.float32), 256)
        pname, sname = f"{n.inputs[1]}__w4", f"{n.inputs[1]}__w4s"
        consts[pname], consts[sname] = packed, scales
        weights += [pname, sname]
        nodes.append(Node("MatMulNBits", [n.inputs[0], pname, sname],
                          list(n.outputs), n.name,
                          {"K": K, "N": N, "bits": 4,
                           "block_size": K // scales.shape[1]},
                          domain="com.microsoft"))
    g = Graph(name=f"{graph.name}_ort4", nodes=nodes, constants=consts,
              inputs=graph.inputs, outputs=list(graph.outputs),
              opset=graph.opset, opsets=dict(graph.opsets),
              weight_names=weights)
    prune_dead(g)
    return g


def ort_int4_generator(gen):
    """gen's prefill and decode graphs rewritten by ort_int4_weights,
    exported and serialized to ONNX bytes, parsed and imported again, and
    set as gen's engines: the path an ORT-quantized file takes. Returns the
    two graphs' bytes."""
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.graph import (
        export_model, import_model)

    blobs = [onnx_io.serialize_model(export_model(ort_int4_weights(g)))
             for g in (gen.prefill.graph, gen.decode.graph)]
    gen._engines(*(import_model(onnx_io.parse_model(b)) for b in blobs))
    return blobs


def phase_ort_decode():
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(n_layer=GPT2_SIDE_LAYERS)  # SMALL's widths
    prompts = _decode_prompts(cfg)
    t0 = time.perf_counter()
    gen = _generator(cfg, kv_dtype="int8", fused_attention=True)
    onnx_bytes = sum(map(len, ort_int4_generator(gen)))
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    per_graph = []
    for g in (gen.prefill.graph, gen.decode.graph):
        nbits = [n for n in g.nodes if n.op_type == "MatMulNBits"]
        require(all("layout" not in n.attrs for n in nbits),
                "ORT-form MatMulNBits carry no layout attribute")
        per_graph.append(len(nbits))
    n4_pre, n4_dec = per_graph
    n_attn = sum(n.op_type == "FusedDecodeAttention"
                 for n in gen.decode.graph.nodes)
    require(n4_pre == n4_dec == 4 * cfg.n_layer + 1 and n_attn == cfg.n_layer,
            f"4L + 1 MatMulNBits per graph and L fused attentions: "
            f"{n4_pre}, {n4_dec}, {n_attn}")

    # the main path
    reset_counts()
    t0 = time.perf_counter()
    toks, _ = gen.generate(prompts, NEW)
    counts = read_counts()
    main_s = time.perf_counter() - t0
    steps = NEW - 1
    require(counts["qmatmul_int4_bf16"] == n4_pre + n4_dec * steps,
            f"4L + 1 interleaved int4 launches per prefill and per step: "
            f"{counts}")
    schedules = _int4_schedules(gen, "qmatmul_int4_bf16", steps)
    require(schedules == {"general": 0, "small_m": n4_dec * steps,
                          "mma": n4_pre},
            f"GPT-2: every prefill launch on mma, every step launch on "
            f"small_m: {schedules}")
    require(counts["decode_attention_int8"] == n_attn * steps,
            f"L attention launches per step: {counts}")
    require(sum(counts.values()) == counts["qmatmul_int4_bf16"]
            + counts["decode_attention_int8"],
            f"no planar int4 or other kernel on this path: {counts}")
    require(toks.shape == (DEC_BATCH, NEW) and toks.min() >= 0
            and toks.max() < cfg.vocab_size, f"tokens {toks.shape}")
    errs, agree = _plain_rerun(gen, prompts, toks)
    emit({"phase": "ort_decode", "model": f"{GPT2_SIDE}, interleaved "
          "(ORT MatMulNBits) int4 weights, block 256",
          "batch": DEC_BATCH, "prompt": PROMPT, "max_len": MAX_LEN,
          "new_tokens": NEW, "build_s": build_s, "onnx_bytes": onnx_bytes,
          "main_path_s": main_s, "launches": counts,
          "int4_schedules": schedules,
          "int4_per_prefill": n4_pre, "int4_per_step": n4_dec,
          "attention_per_step": n_attn,
          "card_vs_plain_rel_err": errs, "plain_greedy_agreement": agree,
          "decode_tokens_per_s": _decode_tokens_per_s(gen, prompts),
          "tokens_row0": toks[0, :16].tolist()})
    return gen, counts


# --------------------------------------------------------------------------
# BERT-base INT8 encoder
# --------------------------------------------------------------------------
OUTS = ("last_hidden_state", "pooler_output")


def _rel_err(got, want) -> float:
    """max|got - want| / max|want|, of tensors (on any device) or arrays."""
    got, want = (torch.as_tensor(t).cpu() for t in (got, want))
    return float((got - want).abs().max() / want.abs().max())


def _node_cpu(graph, node, feeds: dict):
    """One node of `graph` alone, fed `feeds` (input name -> CPU tensor)
    for its inputs that are not constants, through the plain versions on
    the CPU: its first output."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.graph import Graph, InputSpec
    from onnx_rusty_inference_engine_tpu_torch.weights import (
        params_from_numpy)

    one = Graph(name="one", nodes=[node], constants=graph.constants,
                inputs=[InputSpec(k, tuple(v.shape), np.int8)
                        for k, v in feeds.items()],
                outputs=[node.outputs[0]], opset=graph.opset,
                weight_names=graph.weight_names)
    params = params_from_numpy({k: graph.constants[k]
                                for k in graph.weight_names
                                if k in node.inputs}, "cpu")
    with torch.no_grad():
        return P.lower(one, "cpu")(params, feeds)[node.outputs[0]]


def _run_node_cpu(graph, node, x):
    """One node of `graph` alone, fed x as its first input, through the
    plain versions on the CPU: its first output."""
    return _node_cpu(graph, node, {node.inputs[0]: x})


def _bert_feed(vocab: int) -> dict:
    """Token ids, segment ids, and a mask that keeps each sequence for a
    random length in T/4..T (32-128) and pads the rest."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (BERT_BATCH, BERT_SEQ))
    seg = rng.integers(0, 2, (BERT_BATCH, BERT_SEQ))
    keep = rng.integers(BERT_SEQ // 4, BERT_SEQ + 1, (BERT_BATCH, 1))
    return {"input_ids": ids, "token_type_ids": seg,
            "attention_mask": (np.arange(BERT_SEQ)[None] < keep).astype(
                np.int64)}


def phase_bert():
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
    from onnx_rusty_inference_engine_tpu_torch.models.bert import (
        BASE, build_bert)
    from onnx_rusty_inference_engine_tpu_torch.utils.timing import (
        engine_throughput)

    def graph_at(batch):  # the graph bakes B and T into its Reshapes
        return P.import_model(build_bert(BASE, batch=batch, seq_len=BERT_SEQ,
                                         seed=0))

    def first(n):
        return {k: v[:n] for k, v in feed.items()}

    feed = _bert_feed(BASE.vocab_size)
    t0 = time.perf_counter()
    graph, calib_graph = graph_at(BERT_BATCH), graph_at(BERT_CALIB)
    build_s = time.perf_counter() - t0

    # the main path
    reset_counts()
    t0 = time.perf_counter()
    eng = P.Engine(graph)
    y32 = eng(feed)
    require(tuple(y32["last_hidden_state"].shape)
            == (BERT_BATCH, BERT_SEQ, BASE.hidden)
            and bool(torch.isfinite(y32["last_hidden_state"]).all()),
            "fp32 last_hidden_state")
    fp32_sps = engine_throughput(eng, feed, iters=ITERS, warmup=WARMUP)
    ranges = P.calibrate(calib_graph, [first(BERT_CALIB)], method="minmax")
    qgraph = P.quantize_graph(graph, ranges=ranges)
    n_qmm = sum(n.op_type == "QLinearMatMul" for n in qgraph.nodes)
    require(n_qmm == 6 * BASE.n_layer + 1 == 73,
            f"73 QLinearMatMul nodes in INT8 BERT-base, got {n_qmm}")
    eng8 = P.Engine(qgraph)
    y8 = eng8(feed)
    counts = read_counts()
    require(counts["qmatmul_int8"] == n_qmm,
            f"one int8 GEMM launch per QLinearMatMul: {counts}")
    epilogues = read_splits("qmatmul_int8")["epilogues"]
    require(epilogues == {"int32": 0, "requant": n_qmm},
            f"every QLinearMatMul on the requant epilogue: {epilogues}")
    for name, shape in (("last_hidden_state",
                         (BERT_BATCH, BERT_SEQ, BASE.hidden)),
                        ("pooler_output", (BERT_BATCH, BASE.hidden))):
        require(tuple(y8[name].shape) == shape
                and bool(torch.isfinite(y8[name]).all()), f"INT8 {name}")
    int8_sps = engine_throughput(eng8, feed, iters=ITERS, warmup=WARMUP)
    int8_forwards = 1 + WARMUP + ITERS
    counts = read_counts()
    main_s = time.perf_counter() - t0
    launches = counts["qmatmul_int8"]
    require(launches == n_qmm * int8_forwards,
            f"{launches} launches for {int8_forwards} INT8 forwards")
    require(sum(counts.values()) == launches,
            f"only the int8 GEMM on BERT's path: {counts}")
    epilogues = read_splits("qmatmul_int8")["epilogues"]
    require(epilogues == {"int32": 0, "requant": launches},
            f"every launch on the requant epilogue: {epilogues}")

    # every QLinearMatMul's int8 input and output, and the model's outputs,
    # on the card at B = 32 and through the plain versions on the CPU for
    # the first BERT_CPU sequences (a B = BERT_CPU build, same ranges)
    qmm = [n for n in qgraph.nodes if n.op_type == "QLinearMatMul"]
    names = list(dict.fromkeys(
        [t for n in qmm for t in (n.inputs[0], n.outputs[0])] + list(OUTS)))
    with torch.no_grad():
        card = P.lower(probe_graph(qgraph, names), eng8.device, eng8.packed)(
            eng8.params, {k: torch.as_tensor(v, device=eng8.device)
                          for k, v in feed.items()})
        cpu_graph = graph_at(BERT_CPU)
        qcpu = P.quantize_graph(cpu_graph, ranges=ranges)
        host = P.Engine(probe_graph(qcpu, names), device="cpu")(
            first(BERT_CPU))
        host32 = P.Engine(cpu_graph, device="cpu")(first(BERT_CPU))

    def rows(t):  # the first BERT_CPU sequences, on the CPU
        return t[:BERT_CPU].cpu()

    # (a) fp32: the card's fp32 islands against the plain versions
    fp32_err = {k: _rel_err(rows(y32[k]), host32[k]) for k in OUTS}
    # (b) each QLinearMatMul alone, fed the card's own int8 input: the plain
    # version on the CPU gives the card's output bit for bit
    differ = [n.name for n in qmm if not torch.equal(
        _run_node_cpu(qcpu, n, rows(card[n.inputs[0]])),
        rows(card[n.outputs[0]]))]
    # (c) run free, the card's and the CPU's int8 values part, for
    # information: an fp32 island (LayerNorm, Softmax, Gelu) sums in
    # another order on each device, a value at a requant tie moves one
    # step, and each such step in q / k / v reaches every position of its
    # sequence in the next layer, so the steps multiply layer by layer
    # (PERF.md)
    fracs = [float((rows(card[n.outputs[0]]) == host[n.outputs[0]])
                   .float().mean()) for n in qmm]
    lsb = [int((rows(card[n.outputs[0]]).int() - host[n.outputs[0]].int())
               .abs().max()) for n in qmm]
    # (d) so the outputs are held to the INT8 model's own accuracy: the
    # card's INT8 lies no farther from fp32 than the plain INT8 does
    # (mean |INT8 - fp32| over the first BERT_CPU sequences, within 25%)
    acc = {k: {"card": float((rows(y8[k]) - host32[k]).abs().mean()),
               "plain": float((host[k] - host32[k]).abs().mean()),
               "card_vs_plain_max_abs": float(
                   (rows(card[k]) - host[k]).abs().max())} for k in OUTS}
    emit({"phase": "bert", "model": "bert-base (BASE, seed 0)",
          "batch": BERT_BATCH, "seq_len": BERT_SEQ,
          "mask_lengths": [int(v) for v in feed["attention_mask"].sum(1)],
          "build_s": build_s, "main_path_s": main_s,
          "fp32_sequences_per_s": fp32_sps, "int8_sequences_per_s": int8_sps,
          "int8_over_fp32": int8_sps / fp32_sps,
          "qlinearmatmul_nodes": n_qmm, "int8_forwards": int8_forwards,
          "launches": counts, "epilogues": epilogues,
          "launches_per_int8_forward": launches / int8_forwards,
          "cpu_sequences": BERT_CPU, "fp32_card_vs_plain_rel_err": fp32_err,
          "qlinearmatmul_card_vs_plain_on_card_inputs_differ": differ,
          "int8_free_run_equal_fraction_by_node": fracs,
          "int8_free_run_max_lsb_by_node": lsb,
          "int8_mean_abs_err_vs_fp32": acc,
          "int8_vs_fp32_card_b32": {
              k: _rel_err(y8[k], y32[k]) for k in OUTS}})
    require(max(fp32_err.values()) <= 1e-4, f"fp32 card vs plain: {fp32_err}")
    require(not differ, f"QLinearMatMul card vs plain on the card's inputs: "
            f"{differ}")
    for k in OUTS:
        require(acc[k]["card"] <= 1.25 * acc[k]["plain"],
                f"INT8 {k}: mean |card - fp32| {acc[k]['card']} against "
                f"the plain version's {acc[k]['plain']}")
    return eng, eng8, qgraph, card, launches, feed


# device kernel name fragment -> bucket, first match wins
_BERT_BUCKETS = (("qmatmul_int8", "qmatmul_int8 (int8 GEMM)"),
                 ("softmax", "softmax"), ("layer_norm", "LayerNorm"),
                 ("gemm", "fp32 matmul (cuBLAS)"),
                 ("sm90", "fp32 matmul (cuBLAS)"),
                 ("xmma", "fp32 matmul (cuBLAS)"),
                 ("cutlass", "fp32 matmul (cuBLAS)"),
                 ("reduce", "reductions"), ("index", "gather / index"),
                 ("elementwise", "elementwise / copies"),
                 ("copy", "elementwise / copies"))


def phase_bert_kernels(qgraph, eng8, card, launches: int, smi: str) -> dict:
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels.qmatmul_int8 import (
        int8_tile, qmatmul_int8, qmatmul_int8_plain, qmatmul_int8_requant,
        qmatmul_int8_requant_plain)

    n_qmm = sum(n.op_type == "QLinearMatMul" for n in qgraph.nodes)
    shapes = _qmm_shapes(qgraph, eng8, card)
    require(sum(s["count"] for s in shapes.values()) == n_qmm,
            "the shapes account for every QLinearMatMul")
    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms",
                         "ops_ms", "bytes_ms", "ms_int32"), 0.0)
    for (M, K, N), s in shapes.items():
        a, b, packed = s["a"], s["b"], s["packed"]
        mult, bias = s["mult"], s["bias"]
        bt = b.t().contiguous()

        def library():  # int32 out, no epilogue
            return torch._int_mm(a, bt.t())

        library_ms = graph_ms(library, ITERS)
        library_equal = bool(torch.equal(library(), qmatmul_int8_plain(a, b)))
        epilogues = (
            ("requant",
             lambda: qmatmul_int8_requant(a, b, mult, bias, packed=packed),
             lambda: qmatmul_int8_requant_plain(a, b, mult, bias),
             M * K + K * N + M * N + 8 * N),
            ("int32", lambda: qmatmul_int8(a, b, packed=packed),
             lambda: qmatmul_int8_plain(a, b), M * K + K * N + 4 * M * N))
        for epilogue, kern, plain, nbytes in epilogues:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            require(torch.equal(got, want), f"qmatmul_int8 ({epilogue}) == "
                    f"plain at {s['node']} M={M} K={K} N={N} (max |diff| "
                    f"{err})")
            if epilogue == "requant":  # the main path's own output
                require(torch.equal(got, s["out"]),
                        f"the requant line repeats {s['node']}'s output")
            ms, ms_eager = graph_ms(kern, ITERS), cuda_ms(kern, ITERS)
            plain_ms = cuda_ms(plain, 3)
            ops = 2 * M * N * K
            bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                         INT8_OPS_PER_S)
            emit({"phase": "kernel", "kernel": "qmatmul_int8",
                  "epilogue": epilogue, "node": s["node"], "M": M, "K": K,
                  "N": N, "tile": list(int8_tile(M, N, K)),
                  "count_per_forward": s["count"],
                  "launches": (s["count"] * (launches // n_qmm)
                               if epilogue == "requant" else 0),
                  "equal": True, "max_abs_err": err, "ms": ms,
                  "ms_eager": ms_eager, "plain_ms": plain_ms,
                  "library_ms": library_ms, "library": "torch._int_mm",
                  "library_equal": library_equal, "bound_ms": bound_ms,
                  "bound_by": bound_by, "ops": ops, "bytes": nbytes,
                  "tops": ops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6})
            n = s["count"]
            if epilogue == "int32":
                tot["ms_int32"] += n * ms
                continue
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound_ms), ("library_ms", library_ms),
                         ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                tot[k] += n * v
    require(launches > 0, "qmatmul_int8 launched on the main path")
    source, replaces = KERNEL_ROWS["qmatmul_int8"]
    return {
        "name": "qmatmul_int8", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": 0,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": tot["library_ms"], "ms_int32_epilogue": tot["ms_int32"],
        "per": "one INT8 BERT-base forward at B = 32, T = 128: ms, plain_ms, "
               "bound_ms and library_ms sum its 73 QLinearMatMuls; ms on the "
               "requant epilogue (int8 out, the main path), "
               "ms_int32_epilogue on the int32 one; ms and library_ms "
               "(torch._int_mm, int32 out, no epilogue) are device times "
               "(CUDA-graph replay), plain_ms eager",
        "distinct_shapes": len(shapes), "card": smi}


def phase_nibble(int4_launches: int, smi: str) -> dict:
    """The probe of experiments/cast_probe.py: its 256x256 arange % 251
    uint8 input through the int4 kernels' unpack, bit for bit."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)

    p = torch.from_numpy((np.arange(256 * 256).reshape(256, 256) % 251)
                         .astype(np.uint8)).cuda()
    plo, phi = q4.nibble_probe_plain(p)
    variants_ms = {}
    for variant in q4.NIBBLE_VARIANTS:  # every unpack the schedules use
        probes = q4.nibble_probe.launches
        lo, hi = q4.nibble_probe(p, variant)
        torch.cuda.synchronize()
        require(q4.nibble_probe.launches == probes + 1,
                f"nibble_probe ({variant}) launched")
        require(torch.equal(lo, plo) and torch.equal(hi, phi),
                f"nibble_probe ({variant}) == plain")
        variants_ms[variant] = graph_ms(
            lambda v=variant: q4.nibble_probe(p, v), DEC_ITERS)
    ms = variants_ms["int"]
    plain_ms = cuda_ms(lambda: q4.nibble_probe_plain(p), DEC_ITERS)
    nbytes = p.numel() * (1 + 2 * 4)
    bound_ms, bound_by, _, _ = bound(2 * p.numel(), nbytes, BF16_OPS_PER_S)
    emit({"phase": "kernel", "kernel": "nibble_probe", "input": [256, 256],
          "equal": True, "variants": list(q4.NIBBLE_VARIANTS),
          "variants_ms": variants_ms,
          "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    source, replaces = KERNEL_ROWS["nibble_probe"]
    return {"name": "nibble_probe", "route": "cuda", "source": source,
            "replaces": replaces, "launches": int4_launches,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": "the unpack device functions (nibble.cuh) run inlined in "
                   "every qmatmul_int4_planar and qmatmul_int4_bf16 launch, "
                   "so launches counts those of the three decode paths' "
                   "main runs (GPT-2 planar, GPT-2 ORT layout, Llama); ms, "
                   "plain_ms and bound_ms are "
                   "the exported probe kernel's over cast_probe.py's "
                   "256x256 input with the int variant; every variant is "
                   "bit-equal (times in the kernel line). library_ms: no "
                   "PyTorch call unpacks nibbles",
            "card": smi}


# --------------------------------------------------------------------------
# whole-graph capture, the K-step device loop, the servers
# --------------------------------------------------------------------------
CAPTURE_REPS = 10          # forwards per timing and per count over replays
SERVE_SLOTS, SERVE_REQS, SERVE_NEW = 8, 16, 64
SERVE_BUCKETS = (16, 32, 64)
SERVE_K = 8
ISOLATED_CHECK = 4         # served requests re-run through a batch-1 Generator
CNN_BUCKETS = (1, 8, 64, 256)
CNN_REQS = 120             # InferenceServer requests of 1-8 images
SERVE_WINDOW_REQS = 1200   # served ResNet-50's rate window: ~21 b256 batches


def device_busy(fn, reps: int) -> dict:
    """Host wall ms per call of fn (reps calls, then a synchronize), and
    the device busy ms per call from torch.profiler over another reps
    calls: the sum of the kernels' device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, n = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        busy += us / 1e3 / reps
        n += evt.count
    require(busy > 0, "the profiler saw device time")
    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "device_ops": n / reps}


def _no_forms(module: str) -> dict:
    """Zero launches in each QOperator form a kernel module counts (the
    port's own quantizer's graphs take none)."""
    import importlib

    return dict.fromkeys(importlib.import_module(
        f"{PKG}.ops.kernels.{module}").FORMS, 0)


def phase_capture(model: str, eng8, feed: dict, kernel: str,
                  per_forward: int, splits: dict, feed2: dict) -> None:
    """The INT8 Engine's captured graph (made by the main path's first
    call) against its eager function on the same inputs, bit for bit, for
    the main path's feed and a second one; a returned output not
    overwritten by the next call; launch counts per forward over
    CAPTURE_REPS replays; wall per forward eager and replayed, beside the
    device busy time."""
    dev = [{k: torch.as_tensor(v, device="cuda") for k, v in f.items()}
           for f in (feed, feed2)]
    with torch.no_grad():
        eager = [eng8._fn(eng8.params, f) for f in dev]
        got = [eng8(f) for f in dev]
        kept = {k: v.clone() for k, v in got[0].items()}
        eng8(dev[1])
    torch.cuda.synchronize()
    for want, have in zip(eager, got):
        for name, v in want.items():
            require(torch.equal(have[name], v),
                    f"{model}: captured {name} equals eager bit for bit")
    for name, v in kept.items():
        require(torch.equal(got[0][name], v),
                f"{model}: a returned {name} is the caller's")
    require(len(eng8._graphs) == 1, f"{model}: one graph per signature")
    reset_counts()
    with torch.no_grad():
        for _ in range(CAPTURE_REPS):
            eng8(dev[0])
    counts = read_counts()
    require(counts[kernel] == per_forward * CAPTURE_REPS
            and sum(counts.values()) == counts[kernel],
            f"{model}: {per_forward} {kernel} launches per replayed forward:"
            f" {counts}")
    got_splits = read_splits(kernel)
    want_splits = {k: {v: n * CAPTURE_REPS for v, n in d.items()}
                   for k, d in splits.items()}
    require(got_splits == want_splits,
            f"{model}: per-variant counts over replays {got_splits}")
    (cap,) = eng8._graphs.values()
    with torch.no_grad():
        eager_t = device_busy(lambda: eng8._fn(eng8.params, dev[0]),
                              CAPTURE_REPS)
        replay_t = device_busy(lambda: eng8(dev[0]), CAPTURE_REPS)
        graph_t = device_busy(cap.replay, CAPTURE_REPS)
    batch = int(next(iter(feed.values())).shape[0])
    emit({"phase": "capture", "model": model, "batch": batch,
          "captured_equals_eager": True, "inputs_checked": 2,
          "launches_per_forward": counts[kernel] / CAPTURE_REPS,
          "splits_per_forward": {k: {v: n / CAPTURE_REPS
                                     for v, n in d.items()}
                                 for k, d in got_splits.items()},
          "eager": eager_t, "replayed_call": replay_t,
          "graph_replay_only": graph_t,
          "per_s_eager": batch / eager_t["wall_ms"] * 1e3,
          "per_s_replayed": batch / replay_t["wall_ms"] * 1e3})


def phase_device_loop(gen, prompts, toks, toks_i8) -> None:
    """Phase 6's Generator (the same object, engines and KV scales) with
    device_loop = SERVE_K: greedy tokens equal the host loop's with
    ORIET_ATTN_I8 unset and set, a seeded sampled run bit-equal to the
    host loop's, 49 int4 and 12 attention launches per step over the
    replayed blocks; tokens/s of both loops; one block's wall against its
    device busy time."""
    K = SERVE_K
    steps = NEW - 1
    blocks = -(-steps // K)
    samp = dict(temperature=0.8, top_k=40, top_p=0.95, sample_seed=3)
    never = gen.cfg.vocab_size
    gen.device_loop = 0
    want_s, _ = gen.generate(prompts, NEW, **samp)
    gen.device_loop = K
    try:
        got = gen.generate(prompts, NEW)[0]             # eager block, capture
        greedy_block = gen._blocks[next(iter(gen._blocks))]
        reset_counts()
        got2 = gen.generate(prompts, NEW)[0]            # replays
        counts = read_counts()
        os.environ["ORIET_ATTN_I8"] = "1"
        try:
            got_i8 = gen.generate(prompts, NEW)[0]
        finally:
            del os.environ["ORIET_ATTN_I8"]
        got_s = gen.generate(prompts, NEW, **samp)[0]
        got_s2 = gen.generate(prompts, NEW, **samp)[0]
        tps_dl = _decode_tokens_per_s(gen, prompts)
        # an eos id no row emits: the host loop reads `done` every step,
        # the device loop once a block
        tps_dl_eos = _decode_tokens_per_s(gen, prompts, eos_id=never)
        with torch.no_grad():
            block_t = device_busy(greedy_block["replay"], 5)
    finally:
        gen.device_loop = 0
    require(np.array_equal(got, toks) and np.array_equal(got2, toks),
            "device_loop greedy tokens equal the host loop's")
    require(np.array_equal(got_i8, toks_i8),
            "device_loop greedy tokens equal the host loop's (ORIET_ATTN_I8)")
    require(np.array_equal(got_s, want_s) and np.array_equal(got_s2, want_s),
            "device_loop sampled tokens equal the host loop's, bit for bit")
    n4 = 4 * gen.cfg.n_layer + 1
    require(counts["qmatmul_int4_planar"] == n4 * (1 + blocks * K)
            and counts["decode_attention_int8"] == gen.cfg.n_layer
            * blocks * K, f"49 int4 and 12 attention launches per step "
            f"over {blocks} replayed blocks: {counts}")
    tps_host = _decode_tokens_per_s(gen, prompts)
    tps_host_eos = _decode_tokens_per_s(gen, prompts, eos_id=never)
    emit({"phase": "device_loop", "model": "gpt2 124M (SMALL, seed 0), "
          "int4 planar, int8 KV, fused attention", "batch": DEC_BATCH,
          "K": K, "new_tokens": NEW, "blocks": blocks,
          "greedy_equals_host": True, "i8attn_equals_host": True,
          "sampled_equals_host": True, "sampling": samp,
          "launches": counts,
          "int4_per_step": counts["qmatmul_int4_planar"] / (1 + blocks * K),
          "tokens_per_s_device_loop": tps_dl,
          "tokens_per_s_host_loop": tps_host,
          "tokens_per_s_device_loop_eos_set": tps_dl_eos,
          "tokens_per_s_host_loop_eos_set": tps_host_eos,
          "block_replay": block_t,
          "step_wall_ms": block_t["wall_ms"] / K,
          "step_busy_ms": block_t["busy_ms"] / K})


def _serve_requests(cfg):
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 65, SERVE_REQS)
    return [rng.integers(0, cfg.vocab_size, (int(n),)) for n in lens]


def _run_decode_server(cfg, prompts, K: int, new: int = SERVE_NEW, **kw):
    """DecodeServer (INT4 planar weights, INT8 KV, SERVE_SLOTS slots,
    SERVE_BUCKETS) at multi_step K, after a warm-up request per bucket:
    (server, token lists, wall s, counts, stats) for `new` tokens of each
    prompt. kw: more DecodeServer arguments (family)."""
    from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer

    srv = DecodeServer(cfg, slots=SERVE_SLOTS, prompt_len=SERVE_BUCKETS[-1],
                       max_len=MAX_LEN, kv_dtype="int8", int4_weights=True,
                       prompt_buckets=SERVE_BUCKETS, multi_step=K,
                       autostart=False, **kw)
    # a first pass captures every graph: one request per prompt bucket
    warm = [srv.submit(p[:b], 2) for p, b in zip(prompts, SERVE_BUCKETS)]
    srv.start()
    for f in warm:
        f.result(timeout=600)
    srv._latencies.clear()
    srv.steps = srv.tokens_out = srv.requests_done = srv._occupancy_sum = 0
    reset_counts()
    t0 = time.perf_counter()
    futs = [srv.submit(p, new) for p in prompts]
    outs = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    counts = read_counts()
    stats = srv.stats()
    return srv, outs, wall, counts, stats


def phase_serve(smi: str) -> None:
    """DecodeServer on GPT-2 124M's widths (GPT2_SIDE_LAYERS layers) at
    multi_step 0 and SERVE_K, the same SERVE_REQS requests; InferenceServer
    on SqueezeNet 1.0 INT8."""
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(n_layer=GPT2_SIDE_LAYERS)
    prompts = _serve_requests(cfg)
    res = {}
    for K in (0, SERVE_K):
        srv, outs, wall, counts, stats = _run_decode_server(cfg, prompts, K)
        block = None
        if K:
            with torch.no_grad():
                block = device_busy(srv._blocks[("greedy", MAX_LEN)], 5)
        srv.stop()
        require(all(len(o) == SERVE_NEW for o in outs)
                and all(0 <= t < cfg.vocab_size for o in outs for t in o),
                f"multi_step={K}: {SERVE_NEW} tokens per request")
        require(counts["qmatmul_int4_planar"] > 0
                and counts["decode_attention_int8"] == 0
                and counts["qconv_int8_requant"] == 0, f"counts {counts}")
        res[K] = {"outs": outs, "wall_s": wall, "counts": counts,
                  "stats": stats, "block": block}
        del srv
        torch.cuda.empty_cache()
    require(res[SERVE_K]["outs"] == res[0]["outs"],
            f"multi_step={SERVE_K} tokens equal multi_step=0's for all "
            f"{SERVE_REQS} requests")
    agree = []
    for p, o in list(zip(prompts, res[0]["outs"]))[:ISOLATED_CHECK]:
        g = Generator(cfg, batch=1, prompt_len=p.size, max_len=MAX_LEN,
                      kv_dtype="int8", int4_weights=True)
        want = g.generate(p[None], SERVE_NEW)[0][0]
        agree.append(float(np.mean(np.asarray(o) == want)))
        del g
        torch.cuda.empty_cache()
    for K, r in res.items():
        st = r["stats"]
        emit({"phase": "serve", "server": "DecodeServer",
              "model": f"{GPT2_SIDE}, int4 planar, int8 KV",
              "slots": SERVE_SLOTS, "requests": SERVE_REQS,
              "new_tokens": SERVE_NEW, "prompt_buckets": SERVE_BUCKETS,
              "max_len": MAX_LEN, "multi_step": K,
              "tokens_equal_multi_step_0": True,
              "isolated_batch1_agreement": agree,
              "served_tokens_per_s": SERVE_REQS * SERVE_NEW / r["wall_s"],
              "wall_s": r["wall_s"], "p50_latency_s": st["p50_latency_s"],
              "p99_latency_s": st["p99_latency_s"],
              "decode_dispatches": st["decode_steps"],
              "mean_slot_occupancy": st["mean_slot_occupancy"],
              "launches": r["counts"], "block_replay": r["block"],
              "card": smi})
    phase_serve_cnn(smi)


def phase_serve_cnn(smi: str) -> None:
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.serve import InferenceServer

    graph = P.import_model(P.build_squeezenet())
    rng = np.random.default_rng(0)
    calib = rng.standard_normal((CALIB, 3, 224, 224)).astype(np.float32)
    qgraph = P.quantize_graph(graph, ranges=P.calibrate(
        graph, [{"data_0": calib}]))
    eng8 = P.Engine(qgraph)
    seen, call_ms = [], []

    class Recording:
        """eng8, keeping each packed batch the server ran and its output."""
        graph = eng8.graph

        def __call__(self, feed):
            t = time.perf_counter()
            out = eng8(feed)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t) * 1e3)
            seen.append((feed["data_0"], out["softmaxout_1"]))
            return out

    t0 = time.perf_counter()
    srv = InferenceServer(Recording(), batch_buckets=CNN_BUCKETS,
                          max_delay_s=0.002, autostart=False)
    srv.warmup((3, 224, 224))
    warm_s = time.perf_counter() - t0
    require(len(eng8._graphs) == len(CNN_BUCKETS),
            f"warmup captured every bucket: {len(eng8._graphs)}")
    seen.clear()
    call_ms.clear()
    sizes = rng.integers(1, 9, CNN_REQS)
    images = [rng.standard_normal((int(n), 3, 224, 224)).astype(np.float32)
              for n in sizes]
    reset_counts()
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit(x) for x in images]
    outs = [f.result(timeout=600)["softmaxout_1"] for f in futs]
    wall = time.perf_counter() - t0
    srv.stop()
    counts = read_counts()
    summary = srv.stats.summary()
    # each batch's output is the eager function's on the same padded
    # bucket batch, and each request's rows are a slice of one of them
    buckets = []
    with torch.no_grad():
        for x, o in seen:
            buckets.append(int(x.shape[0]))
            want = eng8._fn(eng8.params, {"data_0": torch.as_tensor(
                x, device="cuda")})["softmaxout_1"]
            require(torch.equal(o, want),
                    "InferenceServer batch equals the Engine's eager run")
    pool = np.concatenate([o.cpu().numpy() for _, o in seen]).reshape(
        -1, 1000)
    for x, o in zip(images, outs):
        rows = o.reshape(len(x), -1)
        require(any(np.array_equal(pool[i:i + len(x)], rows)
                    for i in range(pool.shape[0] - len(x) + 1)),
                "every request's rows are a slice of a served batch")
    require(counts["qconv_int8_requant"] == 26 * len(seen),
            f"26 convs per served batch: {counts}")
    # where a b256 batch's host time goes: the pageable copy of its images
    # to the card, and the replay alone
    big = next(x for x, _ in seen if x.shape[0] == CNN_BUCKETS[-1])
    h2d_ms = cuda_ms(lambda: torch.from_numpy(big).to("cuda"), 5)
    t0 = time.perf_counter()
    np.concatenate([big[i:i + 4] for i in range(0, len(big), 4)])
    pack_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "serve", "server": "InferenceServer",
          "model": "squeezenet1.0 int8 224x224", "buckets": CNN_BUCKETS,
          "requests": CNN_REQS, "images": int(sizes.sum()),
          "batches": len(seen), "batch_sizes": buckets,
          "results_equal_engine": True, "warmup_s": warm_s,
          "engine_call_ms": call_ms, "h2d_ms_b256": h2d_ms,
          "np_concatenate_ms_b256": pack_ms,
          "images_per_s": int(sizes.sum()) / wall, "wall_s": wall,
          "p50_latency_s": summary["p50_latency_s"],
          "p99_latency_s": summary["p99_latency_s"],
          "padding_overhead": summary["padding_overhead"],
          "launches": counts, "card": smi})


# --------------------------------------------------------------------------
# Llama decode: GQA, RoPE, SwiGLU, RMSNorm at LlamaConfig()'s widths
# --------------------------------------------------------------------------
LLAMA_LAYERS = 1           # of LlamaConfig()'s 32: the depth cut
LLAMA_SERVE_NEW = 32       # new tokens per served request


def _llama_counts(gen) -> tuple:
    """(MatMulNBits in the prefill graph, in the decode graph, fused
    attentions in the decode graph)."""
    return (sum(n.op_type == "MatMulNBits" for n in gen.prefill.graph.nodes),
            sum(n.op_type == "MatMulNBits" for n in gen.decode.graph.nodes),
            sum(n.op_type == "FusedDecodeAttention"
                for n in gen.decode.graph.nodes))


def _step_weight_bytes(gen) -> int:
    """Bytes of the int4 weights and scales one decode step reads."""
    params = gen.decode.params
    return sum(params[n.inputs[i]].numel() * params[n.inputs[i]].element_size()
               for n in gen.decode.graph.nodes if n.op_type == "MatMulNBits"
               for i in (1, 2))


def _llama_main_path(gen, prompts, what: str, attention: str = None):
    """Drive gen.generate once with every count set to 0 just before and
    read just after: (tokens, counts, seconds). Holds every int4 launch to
    its schedule (the prefill all on mma; a step's L down projections,
    K = 16384, on mma and its other 6 L + 1 launches on small_m), 7 L + 1
    int4 launches per pass and L `attention` launches per step, for L =
    LLAMA_LAYERS."""
    L = LLAMA_LAYERS
    steps = NEW - 1
    n4_pre, n4_dec, _ = _llama_counts(gen)
    reset_counts()
    t0 = time.perf_counter()
    toks, _ = gen.generate(prompts, NEW)
    counts = read_counts()
    seconds = time.perf_counter() - t0
    require(n4_pre == n4_dec == 7 * L + 1, f"{what}: {7 * L + 1} "
            f"MatMulNBits per graph: {n4_pre}, {n4_dec}")
    require(counts["qmatmul_int4_planar"] == n4_pre + n4_dec * steps,
            f"{what}: {7 * L + 1} int4 launches per prefill and per step: "
            f"{counts}")
    schedules = _int4_schedules(gen, "qmatmul_int4_planar", steps)
    require(schedules == {"general": 0, "small_m": (6 * L + 1) * steps,
                          "mma": n4_pre + L * steps},
            f"{what}: the prefill on mma, per step {6 * L + 1} small_m and "
            f"{L} mma: "
            f"{schedules}")
    attn = {"decode_attention_int8": 0, "decode_attention_int8_mxu": 0}
    if attention:
        attn[attention] = L * steps
    require(all(counts[k] == v for k, v in attn.items())
            and sum(counts.values()) == counts["qmatmul_int4_planar"]
            + sum(attn.values()),
            f"{what}: {attn} and no other kernel: {counts}")
    require(toks.shape == (DEC_BATCH, NEW) and toks.min() >= 0
            and toks.max() < gen.cfg.vocab_size, f"{what}: tokens")
    return toks, counts, schedules, seconds


def phase_llama(smi: str) -> dict:
    """The llama slice at LlamaConfig()'s widths with LLAMA_LAYERS of its
    32 layers (random weights from seed 0; every graph built inside
    models.host_memo, so the weights are drawn and packed once): the
    Generator paths (INT4 + INT8 KV + fused attention, with and without
    ORIET_ATTN_I8; INT4 + INT4 KV unfused; device_loop) each held to the
    plain versions or to the host loop, DecodeServer at multi_step 0 and
    8, one step's profile, the kernel lines of the new int4 and GQA
    attention shapes. Returns each kernel's llama-path numbers."""
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.models import host_memo
    from onnx_rusty_inference_engine_tpu_torch.models.llama import (
        LlamaConfig)

    cfg = LlamaConfig(n_layer=LLAMA_LAYERS)
    prompts = _decode_prompts(cfg)
    L, steps, K = LLAMA_LAYERS, NEW - 1, SERVE_K
    model = (f"llama-7b widths (LlamaConfig(): dim 4096, 32 heads / 8 KV "
             f"heads of 128, FFN 16384, vocab 32000), {L} of 32 layers, "
             f"seed 0")
    out, rows = {"phase": "llama", "model": model}, {}
    with host_memo():
        # 1. INT4 planar weights, INT8 KV, fused attention
        t0 = time.perf_counter()
        gen = _generator(cfg, family="llama", kv_dtype="int8",
                         int4_weights=True, fused_attention=True)
        out["build_s"] = time.perf_counter() - t0
        require(_llama_counts(gen)[2] == L, f"{L} fused attentions")
        toks, counts, schedules, out["main_path_s"] = _llama_main_path(
            gen, prompts, "fused", "decode_attention_int8")
        t0 = time.perf_counter()
        errs, agree = _plain_rerun(gen, prompts, toks)
        out.update(launches=counts, int4_schedules=schedules,
                   card_vs_plain_rel_err=errs, plain_greedy_agreement=agree,
                   plain_rerun_s=time.perf_counter() - t0,
                   step_int4_weight_bytes=_step_weight_bytes(gen),
                   tokens_row0=toks[0, :16].tolist())
        out["step_weight_bound_ms"] = (out["step_int4_weight_bytes"]
                                       / HBM_BYTES_PER_S * 1e3)
        tps = {"int4_int8kv_fused": _decode_tokens_per_s(gen, prompts)}

        # 2. the same path with the int8 x int8 attention
        os.environ["ORIET_ATTN_I8"] = "1"
        try:
            toks_i8, counts_i8, _, _ = _llama_main_path(
                gen, prompts, "ORIET_ATTN_I8", "decode_attention_int8_mxu")
            tps["int4_int8kv_fused_i8attn"] = _decode_tokens_per_s(
                gen, prompts)
        finally:
            del os.environ["ORIET_ATTN_I8"]
        out.update(launches_i8attn=counts_i8,
                   i8attn_token_agreement=float((toks_i8 == toks).mean()))

        # 4. device_loop = K on the same Generator
        blocks = -(-steps // K)
        gen.device_loop = K
        try:
            first = gen.generate(prompts, NEW)[0]       # eager block, capture
            block = gen._blocks[next(iter(gen._blocks))]
            reset_counts()
            again = gen.generate(prompts, NEW)[0]       # replays
            counts_dl = read_counts()
            tps["int4_int8kv_fused_device_loop"] = _decode_tokens_per_s(
                gen, prompts)
            with torch.no_grad():
                block_t = device_busy(block["replay"], 5)
        finally:
            gen.device_loop = 0
        require(np.array_equal(first, toks) and np.array_equal(again, toks),
                "device_loop greedy tokens equal the host loop's")
        require(counts_dl["qmatmul_int4_planar"] == (7 * L + 1) * (
                    1 + blocks * K)
                and counts_dl["decode_attention_int8"] == L * blocks * K,
                f"{7 * L + 1} int4 and {L} attention launches per step over "
                f"{blocks} replayed blocks: {counts_dl}")
        out.update(device_loop={"K": K, "blocks": blocks,
                                "greedy_equals_host": True,
                                "launches": counts_dl,
                                "block_replay": block_t,
                                "step_wall_ms": block_t["wall_ms"] / K,
                                "step_busy_ms": block_t["busy_ms"] / K})

        # 6. one step under the profiler
        prof = phase_decode_profile(
            gen, prompts, engine=f"llama {L}-layer decode step (int4, int8 "
                                 f"KV, fused)")
        out["step_profile"] = {k: prof[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_idle_share", "busy_share_by_bucket")}

        # 7. kernel lines: the int4 shapes, the GQA attention shape
        rows["qmatmul_int4_planar"] = int4_kernel_row(
            gen, "qmatmul_int4_planar", counts["qmatmul_int4_planar"], smi,
            per=f"one {L}-layer Llama decode step at batch 8 (llama-7b "
                f"widths): the sum over its {7 * L + 1} launches (7 per layer "
                f"+ the lm_head)")
        rows.update(_llama_attention_rows(gen, prompts, counts, counts_i8,
                                          smi))
        del gen
        torch.cuda.empty_cache()

        # 3. INT4 KV (nibble-packed), unfused attention
        t0 = time.perf_counter()
        gen4 = _generator(cfg, family="llama", kv_dtype="int4",
                          int4_weights=True)
        out["int4kv_build_s"] = time.perf_counter() - t0
        toks4, counts4, _, _ = _llama_main_path(gen4, prompts, "int4 KV")
        errs4, agree4, own4 = _plain_rerun(gen4, prompts, toks4,
                                           same_cache=True)
        tps["int4_int4kv_unfused"] = _decode_tokens_per_s(gen4, prompts)
        out.update(int4kv={"launches": counts4,
                           "card_vs_plain_rel_err": errs4,
                           "card_vs_plain_own_cache_rel_err": own4,
                           "plain_greedy_agreement": agree4,
                           "token_agreement_with_int8kv": float(
                               (toks4 == toks).mean())},
                   decode_tokens_per_s=tps)
        del gen4
        torch.cuda.empty_cache()

        # 5. DecodeServer
        reqs = _serve_requests(cfg)
        served = {}
        for k in (0, K):
            t0 = time.perf_counter()
            srv, outs, wall, counts_s, stats = _run_decode_server(
                cfg, reqs, k, new=LLAMA_SERVE_NEW, family="llama")
            blk = None
            if k:
                with torch.no_grad():
                    blk = device_busy(srv._blocks[("greedy", MAX_LEN)], 5)
            srv.stop()
            require(all(len(o) == LLAMA_SERVE_NEW for o in outs)
                    and all(0 <= t < cfg.vocab_size for o in outs for t in o),
                    f"llama multi_step={k}: {LLAMA_SERVE_NEW} tokens each")
            require(counts_s["qmatmul_int4_planar"] > 0
                    and counts_s["decode_attention_int8"] == 0,
                    f"llama serve counts {counts_s}")
            served[k] = {"outs": outs, "wall_s": wall, "counts": counts_s,
                         "stats": stats, "block": blk,
                         "build_and_run_s": time.perf_counter() - t0}
            del srv
            torch.cuda.empty_cache()
        require(served[K]["outs"] == served[0]["outs"],
                f"llama: multi_step={K} tokens equal multi_step=0's for all "
                f"{SERVE_REQS} requests")
        out["serve"] = {k: {
            "multi_step": k, "tokens_equal_multi_step_0": True,
            "served_tokens_per_s": SERVE_REQS * LLAMA_SERVE_NEW / r["wall_s"],
            "wall_s": r["wall_s"], "build_and_run_s": r["build_and_run_s"],
            "p50_latency_s": r["stats"]["p50_latency_s"],
            "p99_latency_s": r["stats"]["p99_latency_s"],
            "decode_dispatches": r["stats"]["decode_steps"],
            "launches": r["counts"], "block_replay": r["block"]}
            for k, r in served.items()}
    out.update(batch=DEC_BATCH, prompt=PROMPT, max_len=MAX_LEN,
               new_tokens=NEW, serve_slots=SERVE_SLOTS,
               serve_buckets=SERVE_BUCKETS, serve_requests=SERVE_REQS,
               serve_new=LLAMA_SERVE_NEW, card=smi)
    emit(out)
    return rows


def _llama_attention_rows(gen, prompts, counts, counts_i8, smi) -> dict:
    """Both attention kernels at the llama step's GQA shape (32 query heads
    on 8 KV heads of 128, L = MAX_LEN, the first step's valid rows) on the
    prefill's real layer-0 cache: kernel lines, and each kernel's numbers
    for one step (LLAMA_LAYERS launches)."""
    rng = np.random.default_rng(1)
    _, cache = gen.start(prompts)
    H, Hkv, hd = gen.cfg.n_head, gen.cfg.n_kv_head, gen.cfg.head_dim
    k8 = cache["past_key_0"].reshape(DEC_BATCH * Hkv, MAX_LEN, hd)
    v8 = cache["past_value_0"].reshape(DEC_BATCH * Hkv, MAX_LEN, hd)
    q = torch.from_numpy((rng.standard_normal((DEC_BATCH * H, 1, hd))
                          / (127 * np.sqrt(hd))).astype(np.float32)).cuda()
    valid = np.arange(MAX_LEN) <= PROMPT
    bias = torch.from_numpy(np.broadcast_to(
        np.where(valid, 0.0, -1e9).astype(np.float32),
        (DEC_BATCH, 1, MAX_LEN)).copy()).cuda()
    n_valid, n = int(valid.sum()), LLAMA_LAYERS
    rows = {}
    for name, launches in (
            ("decode_attention_int8", counts["decode_attention_int8"]),
            ("decode_attention_int8_mxu",
             counts_i8["decode_attention_int8_mxu"])):
        line = attn_measure(name, q, k8, v8, bias, H, n_valid, plain=True)
        emit({"phase": "kernel", "kernel": name, "path": "llama",
              "q": [DEC_BATCH * H, 1, hd], "kv": [DEC_BATCH * Hkv, MAX_LEN,
                                                  hd],
              "valid_positions": n_valid, "count_per_step": n,
              "launches": launches, **line, "card": smi})
        rows[name] = {
            "launches": launches, "max_abs_err": line["max_abs_err"],
            "max_rel_err": line["max_rel_err"], "ms": n * line["ms"],
            "plain_ms": n * line["plain_ms"],
            "bound_ms": n * line["bound_ms"], "bound_by": line["bound_by"],
            "library_ms": n * line["library_ms"], "cluster": line["cluster"],
            "per": f"one {n}-layer Llama decode step at batch 8, pos 64: {n} "
                   f"launches at GQA 32/8 heads of 128, L 256"}
    return rows


# --------------------------------------------------------------------------
# Vision families: ResNet-50, MobileNetV2 and ViT-B/16, fp32 and INT8
# --------------------------------------------------------------------------
VIT_BATCH = 64             # ViT-B/16; ResNet-50 and MobileNetV2 at BATCH

# model -> (input, output, batch, kernel launches per INT8 forward)
VISION = {
    "resnet50": ("data", "logits", BATCH,
                 {"qconv_int8_requant": 53, "qmatmul_int8": 1}),
    "mobilenetv2": ("input", "output", BATCH,
                    {"qconv_int8_requant": 35,
                     "qconv_grouped_int8_requant": 17, "qmatmul_int8": 1}),
    "vit": ("pixel_values", "logits", VIT_BATCH,
            {"qconv_int8_requant": 1, "qmatmul_int8": 73}),
}

# MobileNetV2's 17 grouped convs a forward in the kernel's first design
# (one thread per output pixel and 4 channels), as PERF.md section 6
# records them (H100 80GB HBM3, 700 W): the `grouped_conv` line sets this
# run's time beside it
GROUPED_FIRST_DESIGN_MS = 3.482

# device kernel name fragment -> bucket, first match wins
_VISION_BUCKETS = (
    ("qconv_grouped_int8_requant", "qconv_grouped_int8_requant (grouped)"),
    ("qconv_int8_requant", "qconv_int8_requant (int8 conv)"),
    ("qconv_s2d", "qconv_s2d (the stem's space-to-depth layout)"),
    ("qmatmul_int8", "qmatmul_int8 (int8 GEMM)"),
    ("max_pool", "max-pool"), ("softmax", "softmax"),
    ("layer_norm", "LayerNorm"), ("reduce", "reductions"),
    ("conv", "fp32 conv / matmul (cuDNN, cuBLAS)"),
    ("gemm", "fp32 conv / matmul (cuDNN, cuBLAS)"),
    ("sm90", "fp32 conv / matmul (cuDNN, cuBLAS)"),
    ("xmma", "fp32 conv / matmul (cuDNN, cuBLAS)"),
    ("cutlass", "fp32 conv / matmul (cuDNN, cuBLAS)"),
    ("elementwise", "elementwise / copies"), ("copy", "elementwise / copies"))


def _vision_graph(name: str, batch: int):
    """The model at 224x224, weights from seed 0. The CNNs declare batch 1
    and run any batch; ViT-B/16 bakes its batch into Reshape and Expand
    constants, so it is built at the batch it runs."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models.vit import ViTConfig

    if name == "resnet50":
        return P.import_model(P.build_resnet50())
    if name == "mobilenetv2":
        return P.import_model(P.build_mobilenetv2())
    return P.import_model(P.build_vit(ViTConfig(), batch=batch))


def phase_vision_goldens() -> None:
    """ResNet-50 at 64x64, MobileNetV2 at 96x96 and ViT TINY, batch 1, fp32
    on the card against tests/goldens/ at the golden test's tolerance
    (rtol = atol = 1e-3), on the inputs test_regression_goldens.py::_cases
    draws."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.models.vit import TINY

    rng = np.random.default_rng(123)
    img64 = rng.standard_normal((1, 3, 64, 64)).astype(np.float32)
    img96 = rng.standard_normal((1, 3, 96, 96)).astype(np.float32)
    rng.integers(0, 128, (1, 8))
    rng.standard_normal((1, 3, 224, 224))  # squeezenet's
    vit_x = rng.standard_normal(
        (1, 3, TINY.image_size, TINY.image_size)).astype(np.float32)
    errs = {}
    for name, model, feed, out in (
            ("resnet50", P.build_resnet50(), {"data": img64}, "logits"),
            ("mobilenetv2", P.build_mobilenetv2(), {"input": img96},
             "output"),
            ("vit", P.build_vit(TINY, batch=1), {"pixel_values": vit_x},
             "logits")):
        golden = onnx_io.read_tensor_file(
            os.path.join(HERE, "tests", "goldens", f"{name}.pb")).array
        got = P.Engine(P.import_model(model)).run(feed)[out]
        errs[name] = float(np.abs(got - golden).max())
        require(got.shape == golden.shape
                and np.allclose(got, golden, rtol=1e-3, atol=1e-3),
                f"{name} fp32 golden on the card (max abs err "
                f"{errs[name]})")
    emit({"phase": "vision_goldens", "rtol": 1e-3, "atol": 1e-3,
          "max_abs_err": errs,
          "sizes": {"resnet50": "64x64", "mobilenetv2": "96x96",
                    "vit": "TINY 32x32"}})


def _timed(fn):
    """(fn()'s result, its device ms): one call between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _vision_conv_lines(model: str, qgraph, eng8, card, forwards: int,
                       grouped: bool) -> dict:
    """One kernel line per distinct QLinearConv shape (group 1, or
    grouped) of `model`'s INT8 forward: the kernel on the card's own input
    equal to its plain version and to the main path's output, bit for bit;
    kernel and library times from a replayed CUDA graph, the plain one
    eager; the card's bound. Returns the sums over one forward."""
    from torch.nn import functional as F
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8, qconv_int8 as c8)

    if grouped:
        kname, kern_fn = ("qconv_grouped_int8_requant",
                          g8.qconv_grouped_int8_requant)
        plain_fn = g8.qconv_grouped_int8_requant_plain
    else:
        kname, kern_fn = "qconv_int8_requant", c8.qconv_int8_requant
        plain_fn = c8.qconv_int8_requant_plain
    shapes = _qconv_shapes(qgraph, eng8, card, grouped)
    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms",
                         "library_ms", "ms_same_shapes_as_library", "bytes"),
                   0.0)
    max_err = 0
    for (xs, ws, stride, padding), s in shapes.items():
        x, w, mult, bias = s["x"], s["w"], s["mult"], s["bias"]

        def kern():
            return kern_fn(x, w, mult, bias, stride=stride, padding=padding,
                           packed=s["packed"])

        got = kern()
        want, plain_ms = _timed(lambda: plain_fn(
            x, w, mult, bias, stride=stride, padding=padding))
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        require(torch.equal(got, want), f"{model} {kname} == plain at "
                f"{s['node']} x{xs} w{ws} (max |diff| {err})")
        require(torch.equal(got, s["out"]),
                f"{model} {kname} line repeats {s['node']}'s output")
        require(got.is_contiguous(memory_format=torch.channels_last),
                f"channels-last output at {s['node']}")
        ms = graph_ms(kern, ITERS)
        library_ms = library = None
        (pt, pb), (pl, pr) = padding
        if grouped and (pt, pl) == (pb, pr):
            xf = x.float().contiguous(memory_format=torch.channels_last)
            wf = w.float()
            groups = xs[1] // ws[1]
            library = "F.conv2d f32 channels-last, groups=C (not int8)"
            library_ms = graph_ms(lambda: F.conv2d(
                xf, wf, stride=stride, padding=(pt, pl), groups=groups),
                ITERS)
        elif (not grouped and ws[2:] == (1, 1) and stride == (1, 1)
              and not any(padding[0] + padding[1]) and xs[1] % 8 == 0
              and ws[0] % 8 == 0):
            a = x.permute(0, 2, 3, 1).reshape(-1, xs[1])
            b = w.reshape(ws[0], ws[1])
            library = "torch._int_mm (int32 out, no epilogue; 1x1 only)"
            library_ms = graph_ms(lambda: torch._int_mm(a, b.t()), ITERS)
        ops, nbytes = _conv_work(x, w, stride, padding)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     INT8_OPS_PER_S)
        line = {"phase": "kernel", "kernel": kname, "path": "vision",
                "model": model, "node": s["node"], "x": list(xs),
                "w": list(ws), "stride": list(stride),
                "padding": [list(p) for p in padding],
                "count_per_forward": s["count"],
                "launches": s["count"] * forwards, "equal": True,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "library": library,
                "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
                "bytes": nbytes, "tops": ops / ms / 1e9,
                "gb_per_s": nbytes / ms / 1e6}
        if grouped:
            plan = g8.grouped_plan(xs, ws, stride, padding,
                                   g8.input_align(x))
            line.update({k: plan[k] for k in (
                "form", "tile", "run", "box", "threads", "smem", "tiles")})
            if plan["form"] == "tile" and plan["run"] not in g8.TILE_RUNS:
                # the plan takes all of C as one channel run: the time of
                # the run TILE_RUNS alone would give, on the same inputs
                # (not counted: the wrapper alone counts)
                whole, g8.TILE_WHOLE = g8.TILE_WHOLE, 0
                try:
                    line["split_run"] = g8.grouped_plan(
                        xs, ws, stride, padding, g8.input_align(x))["run"]

                    def split():
                        return g8._launch(x, w, mult, bias, stride, padding,
                                          s["packed"])[0]

                    require(torch.equal(split(), want), f"{model} {kname} "
                            f"on a split channel run == plain at {s['node']}")
                    line["split_run_ms"] = graph_ms(split, ITERS)
                finally:
                    g8.TILE_WHOLE = whole
        else:
            line["producer"], line["tile"] = c8.conv_plan(xs, ws, stride,
                                                          padding)
        emit(line)
        n = s["count"]
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("bytes", nbytes)):
            tot[k] += n * v
        if library_ms is not None:
            tot["library_ms"] += n * library_ms
            tot["ms_same_shapes_as_library"] += n * ms
    return {"per_forward": sum(s["count"] for s in shapes.values()),
            "distinct_shapes": len(shapes), "max_abs_err": max_err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": tot["library_ms"] or None,
            "ms_same_shapes_as_library": tot["ms_same_shapes_as_library"],
            "gb_per_s": tot["bytes"] / tot["ms"] / 1e6}


def _vision_qmm_lines(model: str, qgraph, eng8, card, forwards: int
                      ) -> dict:
    """One kernel line per distinct QLinearMatMul shape of `model`'s INT8
    forward, on its requant epilogue (the main path), as
    _vision_conv_lines does for the convs."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels.qmatmul_int8 import (
        int8_tile, qmatmul_int8_requant, qmatmul_int8_requant_plain)

    shapes = _qmm_shapes(qgraph, eng8, card)
    tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms",
                         "ops_ms", "bytes_ms"), 0.0)
    for (M, K, N), s in shapes.items():
        a, b, mult, bias = s["a"], s["b"], s["mult"], s["bias"]

        def kern():
            return qmatmul_int8_requant(a, b, mult, bias, packed=s["packed"])

        got = kern()
        want, plain_ms = _timed(lambda: qmatmul_int8_requant_plain(
            a, b, mult, bias))
        err = int((got.int() - want.int()).abs().max())
        require(torch.equal(got, want), f"{model} qmatmul_int8 == plain at "
                f"{s['node']} M={M} K={K} N={N} (max |diff| {err})")
        require(torch.equal(got, s["out"]),
                f"{model} qmatmul_int8 line repeats {s['node']}'s output")
        ms = graph_ms(kern, ITERS)
        bt = b.t().contiguous()
        library_ms = graph_ms(lambda: torch._int_mm(a, bt.t()), ITERS)
        ops, nbytes = 2 * M * N * K, M * K + K * N + M * N + 8 * N
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     INT8_OPS_PER_S)
        emit({"phase": "kernel", "kernel": "qmatmul_int8", "path": "vision",
              "model": model, "epilogue": "requant", "node": s["node"],
              "M": M, "K": K, "N": N, "tile": list(int8_tile(M, N, K)),
              "count_per_forward": s["count"],
              "launches": s["count"] * forwards, "equal": True,
              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "library": "torch._int_mm (int32 out, no epilogue)",
              "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
              "bytes": nbytes, "tops": ops / ms / 1e9,
              "gb_per_s": nbytes / ms / 1e6})
        n = s["count"]
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("library_ms", library_ms),
                     ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            tot[k] += n * v
    return {"per_forward": sum(s["count"] for s in shapes.values()),
            "distinct_shapes": len(shapes), "max_abs_err": 0,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                         else "bytes"),
            "library_ms": tot["library_ms"]}


def _predicted_splits(qgraph, eng8, card) -> dict:
    """The per-variant launches one INT8 forward should make, from the
    shapes: each group-1 conv's producer (`conv_plan`), on the requant
    epilogue, a stem (`stem_s2d`: ResNet-50's and MobileNetV2's conv1, ViT
    has none) in the s2d form, each grouped conv's form (`grouped_plan`),
    every QLinearMatMul on the requant epilogue (the quantizer's
    y_zero_point is 0 and its bias int32), and none in a QOperator form
    (the quantizer's zero points are 0 and its types int8)."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8, qconv_int8 as c8, qmatmul_int8 as q8)

    producers = dict.fromkeys(c8.PRODUCERS, 0)
    forms = dict.fromkeys(g8.FORMS, 0)
    conv_forms = dict.fromkeys(c8.FORMS, 0)
    for node in qgraph.nodes:
        if node.op_type != "QLinearConv":
            continue
        x, w = card[node.inputs[0]], eng8.params[node.inputs[3]]
        stride, padding = _qconv_geometry(node, x, w)
        group = int(node.attr("group", 1))
        if group == 1:
            producers[c8.conv_plan(x.shape, w.shape, stride, padding)[0]] += 1
            conv_forms["s2d"] += c8.stem_s2d(x.shape[1], w.shape[2:], stride)
        else:
            forms[g8.grouped_plan(x.shape, w.shape, stride, padding,
                                  g8.input_align(x))["form"]] += 1
    n_qmm = sum(n.op_type == "QLinearMatMul" for n in qgraph.nodes)
    no_forms = dict.fromkeys(c8.FORMS, 0)
    out = {"qconv_int8_requant": {
        "producers": producers, "forms": conv_forms,
        "epilogues": {**dict.fromkeys(c8.EPILOGUES, 0),
                      "requant": sum(producers.values())}},
        "qmatmul_int8": {"epilogues": {**dict.fromkeys(q8.EPILOGUES, 0),
                                       "requant": n_qmm},
                         "forms": dict.fromkeys(q8.FORMS, 0)}}
    if any(forms.values()):
        out["qconv_grouped_int8_requant"] = {"schedules": forms,
                                             "forms": no_forms}
    return out


def phase_vision_model(name: str, smi: str):
    """One vision model at 224x224 through the port's entry points: fp32
    Engine, calibrate on x[:8], quantize_graph, INT8 Engine (each forward
    a captured graph). Counts set to 0 just before, read just after: the
    exact launches per INT8 forward, per producer, form and epilogue as
    the shapes predict. Then every QLinearConv and QLinearMatMul shape
    bit for bit on the card's own inputs, every QLinearAdd against its
    plain re-run on the CPU, INT8 against fp32 within the JAX tests'
    bounds, the layouts, images/s and the profile. Returns (the kernel
    rows' sums for this model, the INT8 Engine)."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph

    inp, out, B, per_forward = VISION[name]
    t0 = time.perf_counter()
    graph = _vision_graph(name, B)
    calib_graph = _vision_graph(name, CALIB) if name == "vit" else graph
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal(
        (B, 3, 224, 224)).astype(np.float32)
    feed = {inp: x}
    dev_feed = {inp: torch.as_tensor(x, device="cuda")}

    # the main path
    reset_counts()
    t0 = time.perf_counter()
    eng = P.Engine(graph)
    y32 = eng(feed)[out]
    fp32_ms = cuda_ms(lambda: eng(dev_feed), ITERS, WARMUP)
    ranges = P.calibrate(calib_graph, [{inp: x[:CALIB]}])
    qgraph = P.quantize_graph(graph, ranges=ranges)
    eng8 = P.Engine(qgraph)
    y8 = eng8(feed)[out]
    int8_ms = cuda_ms(lambda: eng8(dev_feed), ITERS, WARMUP)
    counts = read_counts()
    splits = {k: read_splits(k) for k in per_forward}
    main_s = time.perf_counter() - t0
    forwards = 1 + WARMUP + ITERS

    ops = {}
    for n in qgraph.nodes:
        key = n.op_type
        if key == "QLinearConv" and int(n.attr("group", 1)) > 1:
            key = "QLinearConv (grouped)"
        ops[key] = ops.get(key, 0) + 1
    require(ops.get("QLinearConv", 0)
            == per_forward["qconv_int8_requant"]
            and ops.get("QLinearConv (grouped)", 0)
            == per_forward.get("qconv_grouped_int8_requant", 0)
            and ops.get("QLinearMatMul", 0) == per_forward["qmatmul_int8"],
            f"{name}: QLinear nodes {ops}")
    require({k: v for k, v in counts.items() if v}
            == {k: n * forwards for k, n in per_forward.items()},
            f"{name}: {per_forward} launches per INT8 forward over "
            f"{forwards} forwards: {counts}")
    for t, shape in ((y32, (B, 1000)), (y8, (B, 1000))):
        require(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
                f"{name}: output {tuple(t.shape)}")

    # every QLinear node's operands on the card (the CNNs: every value)
    qnodes = [n for n in qgraph.nodes if n.op_type.startswith("QLinear")]
    names = None if name != "vit" else list(dict.fromkeys(
        t for n in qnodes for t in (n.inputs[0], n.outputs[0])))
    probe = probe_graph(qgraph, names)
    with torch.no_grad():
        card = P.lower(probe, "cuda", eng8.packed)(eng8.params, dev_feed)
    predicted = _predicted_splits(qgraph, eng8, card)
    require(splits == {k: {s: {v: n * forwards for v, n in d.items()}
                           for s, d in sp.items()}
                       for k, sp in predicted.items()},
            f"{name}: per-variant launches {splits} against the shapes' "
            f"{predicted} x {forwards}")
    layouts = _layouts(probe, card)
    for op in ("QLinearConv", "QLinearAdd"):
        row = layouts.get(op)
        require(row is None or row["channels_last"] == row["outputs"],
                f"{name}: every {op} leaves channels-last: {layouts}")

    # each QLinearAdd, fed the card's own int8 inputs, re-run through the
    # plain path on the CPU for the first CPU_CHECK images
    adds = [n for n in qgraph.nodes if n.op_type == "QLinearAdd"]
    differ = [n.name for n in adds if not torch.equal(
        _node_cpu(qgraph, n, {i: card[i][:CPU_CHECK].cpu()
                              for i in (n.inputs[0], n.inputs[3])}),
        card[n.outputs[0]][:CPU_CHECK].cpu())]
    require(not differ, f"{name}: QLinearAdd card vs plain: {differ}")

    rows = {"qconv_int8_requant": _vision_conv_lines(
        name, qgraph, eng8, card, forwards, grouped=False),
        "qmatmul_int8": _vision_qmm_lines(name, qgraph, eng8, card,
                                          forwards)}
    if "qconv_grouped_int8_requant" in per_forward:
        rows["qconv_grouped_int8_requant"] = _vision_conv_lines(
            name, qgraph, eng8, card, forwards, grouped=True)
    for k, row in rows.items():
        row["launches"] = counts[k]
    del card

    # INT8 against fp32, at the JAX tests' bounds
    y32f, y8f = y32.float(), y8.float()
    top1 = float((y8f.argmax(1) == y32f.argmax(1)).float().mean())
    max_abs = float((y8f - y32f).abs().max())
    rel = max_abs / float(y32f.abs().max())
    corr = float(torch.corrcoef(torch.stack([y32f.ravel(),
                                             y8f.ravel()]))[0, 1])
    if name == "resnet50":
        ok, bound_s = top1 == 1.0 or rel < 0.1, "top-1 equal or rel < 0.1"
    elif name == "mobilenetv2":
        ok, bound_s = top1 == 1.0 or max_abs < 0.15, \
            "top-1 equal or max |d| < 0.15"
    else:
        ok, bound_s = corr > 0.95, "correlation > 0.95"
    with torch.no_grad():
        replay = device_busy(lambda: eng8(dev_feed), 5)
    emit({"phase": "vision", "model": name, "size": "224x224", "batch": B,
          "build_s": build_s, "main_path_s": main_s,
          "fp32_images_per_s": B / fp32_ms * 1e3,
          "int8_images_per_s": B / int8_ms * 1e3,
          "int8_over_fp32": fp32_ms / int8_ms,
          "qlinear_nodes": ops, "int8_forwards": forwards,
          "launches": {k: v for k, v in counts.items() if v},
          "launches_per_int8_forward": per_forward, "splits": splits,
          "qlinearadd_card_vs_plain_equal": len(adds),
          "int8_vs_fp32": {"top1_agreement": top1, "max_abs": max_abs,
                           "max_abs_over_max_ref": rel,
                           "correlation": corr, "bound": bound_s},
          "int8_replay": replay, "layout_by_op": layouts, "card": smi})
    require(ok, f"{name}: INT8 against fp32 ({bound_s}): top-1 {top1}, "
            f"max |d| {max_abs}, rel {rel}, corr {corr}")
    phase_profile(eng, eng8, feed, model=f"{name} ", batch=B,
                  buckets_by=_VISION_BUCKETS, glue_op="QLinearAdd")
    return rows, eng8


def phase_serve_resnet(eng8, smi: str) -> None:
    """InferenceServer on ResNet-50 INT8 at 224x224, buckets 1/8/64/256,
    CNN_REQS requests of 1-8 images: each response equal to a direct
    eager Engine call on the same images within rtol = atol = 1e-3
    (tests/test_resnet.py's tolerance); 53 convs and 1 GEMM per served
    batch. Then, for information, the served rate over a window of
    SERVE_WINDOW_REQS requests of the same mix (images reused from the
    checked run), queued before the dispatcher starts: images/s and the
    p50/p99 latency of that backlog, padding overhead, batches. The
    checked run's own rate covers a few batches and start-up; it is kept
    as a smoke figure."""
    from onnx_rusty_inference_engine_tpu_torch.serve import InferenceServer

    rng = np.random.default_rng(0)
    srv = InferenceServer(eng8, batch_buckets=CNN_BUCKETS,
                          max_delay_s=0.002, autostart=False)
    t0 = time.perf_counter()
    srv.warmup((3, 224, 224))
    warm_s = time.perf_counter() - t0
    require(len(eng8._graphs) == len(CNN_BUCKETS),
            f"warmup captured every bucket: {len(eng8._graphs)}")
    sizes = rng.integers(1, 9, CNN_REQS)
    images = [rng.standard_normal((int(n), 3, 224, 224)).astype(np.float32)
              for n in sizes]
    reset_counts()
    srv.start()
    t0 = time.perf_counter()
    futs = [srv.submit(x) for x in images]
    outs = [f.result(timeout=600)["logits"] for f in futs]
    wall = time.perf_counter() - t0
    srv.stop()
    counts = read_counts()
    summary = srv.stats.summary()
    batches = summary["batches"]
    require({k: v for k, v in counts.items() if v}
            == {"qconv_int8_requant": 53 * batches, "qmatmul_int8": batches},
            f"53 convs and 1 GEMM per served batch ({batches}): {counts}")
    worst = 0.0
    with torch.no_grad():
        for x, o in zip(images, outs):
            want = eng8.forward({"data": torch.as_tensor(
                x, device="cuda")})["logits"].cpu().numpy()
            worst = max(worst, float(np.abs(o - want).max()))
            require(o.shape == want.shape
                    and np.allclose(o, want, rtol=1e-3, atol=1e-3),
                    "served ResNet-50 INT8 equals the Engine's call")
    win = InferenceServer(eng8, batch_buckets=CNN_BUCKETS,
                          max_delay_s=0.002, autostart=False)
    picks = [images[i % CNN_REQS] for i in range(SERVE_WINDOW_REQS)]
    win_futs = [win.submit(x) for x in picks]
    t0 = time.perf_counter()
    win.start()
    for f in win_futs:
        f.result(timeout=600)
    win_wall = time.perf_counter() - t0
    win.stop()
    ws = win.stats.summary()
    win_images = sum(len(x) for x in picks)
    emit({"phase": "serve", "server": "InferenceServer",
          "model": "resnet50 int8 224x224", "buckets": CNN_BUCKETS,
          "requests": CNN_REQS, "images": int(sizes.sum()),
          "batches": batches, "results_equal_engine_rtol_1e-3": True,
          "max_abs_diff_vs_engine": worst, "warmup_s": warm_s,
          "smoke_images_per_s": int(sizes.sum()) / wall,
          "smoke_wall_s": wall,
          "smoke_p50_latency_s": summary["p50_latency_s"],
          "smoke_p99_latency_s": summary["p99_latency_s"],
          "window": {"requests": SERVE_WINDOW_REQS, "images": win_images,
                     "batches": ws["batches"],
                     "images_per_s": win_images / win_wall,
                     "wall_s": win_wall,
                     "p50_latency_s": ws["p50_latency_s"],
                     "p99_latency_s": ws["p99_latency_s"],
                     "padding_overhead": ws["padding_overhead"]},
          "launches": counts, "card": smi})


def _cli(*args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", f"{PKG}.cli", *args],
                            cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen, stdin: str = None, timeout: int = 600):
    """(exit code, stdout, stderr) of a subprocess, given `stdin`; killed
    past `timeout` seconds."""
    try:
        out, err = proc.communicate(stdin, timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def phase_vision_cli(smi: str) -> None:
    """The CLI on the card, as subprocesses of
    `python -m onnx_rusty_inference_engine_tpu_torch.cli`: `run` on
    ResNet-50 with resnet50.pb's golden case (files written to a
    temporary directory) must print its golden MATCH line at the golden
    test's tolerance and exit 0; `inspect` must find no unsupported op in
    ResNet-50, MobileNetV2 and ViT (TINY: the op set of ViT-B/16);
    `bench --quantize int8 --batch 256` on the 224x224 ResNet-50."""
    import tempfile

    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.models.vit import TINY

    t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        paths = {m: os.path.join(d, f"{m}.onnx")
                 for m in ("resnet50", "mobilenetv2", "vit_tiny")}
        onnx_io.save_model(paths["resnet50"], P.build_resnet50())
        onnx_io.save_model(paths["mobilenetv2"], P.build_mobilenetv2())
        onnx_io.save_model(paths["vit_tiny"], P.build_vit(TINY, batch=1))
        x = np.random.default_rng(123).standard_normal((1, 3, 64, 64))
        onnx_io.write_tensor_file(os.path.join(d, "in.pb"), "data",
                                  x.astype(np.float32))
        golden = onnx_io.read_tensor_file(
            os.path.join(HERE, "tests", "goldens", "resnet50.pb"))
        onnx_io.write_tensor_file(os.path.join(d, "out.pb"), golden.name,
                                  golden.array)
        procs = {"run": _cli("run", "--model", paths["resnet50"], "--input",
                             os.path.join(d, "in.pb"), "--golden",
                             os.path.join(d, "out.pb"), "--rtol", "1e-3",
                             "--atol", "1e-3")}
        procs.update({f"inspect_{m}": _cli("inspect", "--model", p)
                      for m, p in paths.items()})
        res = {k: _finish(p) for k, p in procs.items()}
        res["bench"] = _finish(_cli(
            "bench", "--model", paths["resnet50"], "--quantize", "int8",
            "--batch", str(BATCH), "--steps", str(ITERS)))
    for k, (rc, out, err) in res.items():
        require(rc == 0, f"cli {k} exited {rc}: {err[-2000:]}")
    golden_line = res["run"][1].strip().splitlines()[-1]
    require(golden_line.startswith("golden: MATCH"),
            f"cli run: {golden_line}")
    inspected = {k: json.loads(out) for k, (_, out, _) in res.items()
                 if k.startswith("inspect_")}
    for k, body in inspected.items():
        require(body["unsupported_ops"] == [],
                f"cli {k}: unsupported {body['unsupported_ops']}")
    bench = json.loads(res["bench"][1].strip().splitlines()[-1])
    require(bench["device"] == torch.cuda.get_device_name(0)
            and bench["images_per_sec"] > 0, f"cli bench: {bench}")
    emit({"phase": "cli", "run": golden_line,
          "inspect": {k: {"n_nodes": b["n_nodes"],
                          "unsupported_ops": b["unsupported_ops"]}
                      for k, b in inspected.items()},
          "bench": bench, "seconds": time.perf_counter() - t0, "card": smi})


# --------------------------------------------------------------------------
# bf16 and dynamic W8A8
# --------------------------------------------------------------------------
PREC_ITERS = 10     # replayed forwards or prefills per timing
PREC_STEPS = 4      # decode steps after each prefill scheme
# BERT-base against fp32 (max |d| / max|ref| per output, B 32 x T 128):
# W8A8 quantizes every activation per row into int8 over 12 layers, held
# to the JAX tests' bound for a deep INT8 network (ResNet-50, 0.1); bf16
# rounds the weights (2^-9), held to 0.02
BERT_W8A8_REL, BERT_BF16_REL = 0.1, 0.02
# decoder prefill logits against fp32: GPT-2 at tests/test_w8a8.py:96-97's
# bounds (a 2-layer GPT-2 there); the Llama decoder at the deep-INT8 bound
# above, since the JAX package's own W8A8 already parts from fp32 by 0.05
# on a 4-layer Llama at dim 512 (tests/test_torch_port_precision.py::
# test_w8a8_llama_error_tracks_jax, on the CPU)
PREFILL_W8A8_REL = {"gpt2": 0.05, "llama": 0.1}
PREFILL_FLIPS_OVER_BF16 = 0.15


def _replayed_ms(eng, dev_feed) -> float:
    """Device ms of one replay of eng's captured graph for dev_feed (the
    first call captures it)."""
    with torch.no_grad():
        eng(dev_feed)
        return cuda_ms(lambda: eng(dev_feed), PREC_ITERS)


def _matmul_integer_row(gq, eng8, dev_feed, launches: int, smi: str) -> dict:
    """Each distinct MatMulInteger shape of the W8A8 BERT graph on the
    card's own int8 activations: the kernel (int32 epilogue) bit-equal to
    qmatmul_int8_plain on the card, its time replayed, the plain version's
    and torch._int_mm's, the bound; and the kernels line's row, summed
    over one forward."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int8 as q8)

    int8_tile, qmatmul_int8 = q8.int8_tile, q8.qmatmul_int8
    qmatmul_int8_plain = q8.qmatmul_int8_plain
    nodes = [n for n in gq.nodes if n.op_type == "MatMulInteger"]
    with torch.no_grad():
        card = P.lower(probe_graph(gq, [n.inputs[0] for n in nodes]),
                       eng8.device, eng8.packed)(eng8.params, dev_feed)
    shapes = {}
    for n in nodes:
        a = card[n.inputs[0]]
        K, N = eng8.params[n.inputs[1]].shape
        key = (a.numel() // K, K, N)
        sh = shapes.setdefault(key, {"count": 0, "node": n.inputs[1],
                                     "a": a.reshape(-1, K).contiguous(),
                                     "b": eng8.params[n.inputs[1]]})
        sh["count"] += 1
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "ops_ms": 0.0, "bytes_ms": 0.0}
    for (M, K, N), sh in shapes.items():
        a, b = sh["a"], sh["b"]
        packed = eng8.packed.get(sh["node"])

        def kern():
            return qmatmul_int8(a, b, packed=packed)

        got, want = kern(), qmatmul_int8_plain(a, b)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"MatMulInteger kernel vs plain at M={M} K={K} N={N}")
        ms = graph_ms(kern, PREC_ITERS)
        plain_ms = cuda_ms(lambda: qmatmul_int8_plain(a, b), 3)
        # B column-major, as the other int8 rows time the library: the
        # layout of cuBLASLt's int8 tensor-core GEMM
        bt = b.t().contiguous()
        library_ms = graph_ms(lambda: torch._int_mm(a, bt.t()), PREC_ITERS)
        require(torch.equal(torch._int_mm(a, bt.t()), want), "torch._int_mm")
        ops, nbytes = 2 * M * K * N, M * K + K * N + 4 * M * N
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     INT8_OPS_PER_S)
        emit({"phase": "kernel", "kernel": "qmatmul_int8",
              "instance": "MatMulInteger (int32 epilogue)",
              "path": "precision", "node": sh["node"], "M": M, "K": K,
              "N": N, "count_per_forward": sh["count"],
              "tile": list(int8_tile(M, N, -(-K // 16) * 16)),
              "bit_equal_plain": True, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": "torch._int_mm",
              "bound_ms": bound_ms, "bound_by": bound_by,
              "tops": ops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6,
              "card": smi})
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("library_ms", library_ms),
                     ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            tot[k] += sh["count"] * v
    source, replaces = KERNEL_ROWS["qmatmul_int8"]
    return {
        "name": "qmatmul_int8_matmul_integer", "route": "cuda",
        "source": source, "replaces": replaces,
        "wrapper": "qmatmul_int8 (int32 epilogue), through MatMulInteger",
        "launches": launches, "max_abs_err": 0.0, "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": tot["library_ms"],
        "per": f"one W8A8 BERT-base forward (B {BERT_BATCH}, T {BERT_SEQ}): "
               f"ms, plain_ms, bound_ms and library_ms (torch._int_mm) sum "
               f"its {len(nodes)} MatMulIntegers; ms and library_ms "
               f"replayed, plain_ms eager",
        "distinct_shapes": len(shapes), "card": smi}


def _precision_bert(smi: str) -> dict:
    """BERT-base at B 32, T 128 as Engine(g), Engine(g, dtype="bfloat16")
    and Engine(quantize_matmuls_w8a8(g)). Returns the MatMulInteger row."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models.bert import (
        BASE, build_bert)
    from onnx_rusty_inference_engine_tpu_torch.quant import (
        quantize_matmuls_w8a8)

    feed = _bert_feed(BASE.vocab_size)
    dev_feed = {k: torch.as_tensor(v, device="cuda")
                for k, v in feed.items()}
    g = P.import_model(build_bert(BASE, batch=BERT_BATCH, seq_len=BERT_SEQ,
                                  seed=0))
    gq = quantize_matmuls_w8a8(g)
    n_mi = sum(n.op_type == "MatMulInteger" for n in gq.nodes)
    require(n_mi == 6 * BASE.n_layer + 1 == 73,
            f"73 MatMulIntegers in W8A8 BERT-base: {n_mi}")
    out, ms = {}, {}
    for name, graph, dtype in (("fp32", g, "float32"),
                               ("bf16", g, "bfloat16"),
                               ("w8a8", gq, "float32")):
        eng = P.Engine(graph, dtype=dtype)
        if name == "w8a8":  # the main path: counts over the replays too
            reset_counts()
        with torch.no_grad():
            out[name] = {k: v.float() for k, v in eng(dev_feed).items()}
        ms[name] = _replayed_ms(eng, dev_feed)
        if name == "w8a8":  # the first call, then 2 + PREC_ITERS replays
            counts = read_counts()
            launches = counts["qmatmul_int8"]
            require(launches == n_mi * (3 + PREC_ITERS)
                    and sum(counts.values()) == launches,
                    f"W8A8 BERT: {n_mi} MatMulInteger launches per forward "
                    f"and no other kernel: {counts}")
            epilogues = read_splits("qmatmul_int8")["epilogues"]
            require(epilogues == {"int32": launches, "requant": 0},
                    f"every MatMulInteger on the int32 epilogue: "
                    f"{epilogues}")
            row = _matmul_integer_row(gq, eng, dev_feed, launches, smi)
            ops_ms = _ms_by_op(eng, dev_feed, 2)[0]
        del eng
        torch.cuda.empty_cache()
    for name in out:
        for k in OUTS:
            require(bool(torch.isfinite(out[name][k]).all()),
                    f"{name} {k} finite")
    rel = {name: {k: _rel_err(out[name][k], out["fp32"][k]) for k in OUTS}
           for name in ("bf16", "w8a8")}
    emit({"phase": "precision", "model": "bert-base (BASE, seed 0)",
          "batch": BERT_BATCH, "seq_len": BERT_SEQ,
          "sequences_per_s": {k: BERT_BATCH / v * 1e3 for k, v in ms.items()},
          "replayed_ms": ms, "rel_err_vs_fp32": rel,
          "w8a8_ops_ms": ops_ms,
          "bounds": {"w8a8": BERT_W8A8_REL, "bf16": BERT_BF16_REL},
          "matmul_integer_nodes": n_mi, "w8a8_forwards": 3 + PREC_ITERS,
          "launches": row["launches"], "card": smi})
    for k in OUTS:
        require(rel["w8a8"][k] < BERT_W8A8_REL, f"W8A8 BERT {k}: {rel}")
        require(rel["bf16"][k] < BERT_BF16_REL, f"bf16 BERT {k}: {rel}")
    return row


def _bf16a_calls(eng, dev_feed, planar: bool) -> list:
    """The int4 wrapper calls of one forward of eng whose A is bf16, on
    the card's own activations (probe_graph on the inputs of its
    MatMulNBits of one layout): [(a [M, K], packed, scales f32, n, nblk,
    blk)], as the MatMulNBits emitter hands them to the wrapper."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)

    def is_planar(n):
        lay = n.attr("layout", "")
        return (lay.decode() if isinstance(lay, bytes) else lay) == "planar"

    nodes = [n for n in eng.graph.nodes
             if n.op_type == "MatMulNBits" and is_planar(n) == planar]
    with torch.no_grad():
        card = P.lower(probe_graph(eng.graph, [x for n in nodes
                                               for x in n.inputs[:3]]),
                       eng.device, eng.packed)(eng.params, dev_feed)
    calls = []
    for n in nodes:
        a, packed = card[n.inputs[0]], card[n.inputs[1]]
        if a.dtype != torch.bfloat16:
            continue
        K, N = int(n.attr("K")), int(n.attr("N"))
        scales = card[n.inputs[2]].to(torch.float32)
        if planar:
            nblk, blk = q4.planar_layout(K, int(n.attr("block_size", K)))
        else:
            nblk = scales.shape[1]
            blk = q4.interleaved_layout(K, packed.shape[1], nblk)
        calls.append((a.reshape(-1, K).contiguous(), packed, scales, N,
                      nblk, blk))
    return calls


def _bf16a_row(name: str, calls, launches: int, smi: str) -> dict:
    """The bf16-A instance of int4 kernel `name` on the card's own bf16
    activations of one prefill (`calls`, from _bf16a_calls): within 1e-5
    x max|out| of the plain twin, times replayed, the library call with
    bf16 A, the bound; the kernels line's row, summed over one prefill."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)

    kern_fn, plain_fn = getattr(q4, name), getattr(q4, name + "_plain")
    planar = name == "qmatmul_int4_planar"
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "ops_ms": 0.0, "bytes_ms": 0.0}
    max_abs = 0.0
    require(calls, f"{name}: bf16-A launches in the prefill")
    for a, packed, scales, n, nblk, blk in calls:
        M, K = a.shape
        Nw = packed.shape[0]
        p = packed.to(torch.int32)
        if planar:
            kw = {"qblock": blk, "n": n}
            q = torch.cat([p & 0xF, p >> 4], dim=1)
            scales_k, bs = scales, blk
        else:
            kw = {"n": n}
            q = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(Nw, K)
            scales_k, bs = scales.t(), 2 * blk

        def kern():
            return kern_fn(a, packed, scales, **kw)

        def plain():
            return plain_fn(a, packed, scales, **kw)

        got, want = kern(), plain()
        as_f32 = kern_fn(a.float(), packed, scales, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(err <= 1e-5 * float(want.abs().max()),
                f"{name} bf16 A vs plain at M={M} K={K} N={n}: {err}")
        require(torch.equal(got, as_f32), f"{name}: bf16 A gives what the "
                f"same values as f32 A give, M={M} K={K} N={n}")
        max_abs = max(max_abs, err)
        ms = graph_ms(kern, PREC_ITERS)
        ms_f32 = graph_ms(lambda: kern_fn(a.float(), packed, scales, **kw),
                          PREC_ITERS)
        plain_ms = cuda_ms(plain, 3)
        lib_label, lib = _int4_library(a, q, scales_k, bs)
        library_ms = graph_ms(lib, PREC_ITERS)
        ops = 2 * M * n * K
        nbytes = M * K * 2 + n * K // 2 + scales.numel() // Nw * n * 4 \
            + M * n * 4
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     BF16_OPS_PER_S)
        emit({"phase": "kernel", "kernel": name, "instance": "bf16 A",
              "path": "precision", "M": M, "K": K, "N": n, "Nw": Nw,
              "schedule": q4.int4_schedule(M, K, nblk, blk),
              "max_abs_err": err, "ms": ms, "ms_same_values_f32_a": ms_f32,
              "plain_ms": plain_ms, "library_ms": library_ms,
              "library": lib_label, "bound_ms": bound_ms,
              "bound_by": bound_by, "gb_per_s": nbytes / ms / 1e6,
              "tflops": ops / ms / 1e9, "card": smi})
        for k, v in (("ms", ms), ("plain_ms", plain_ms),
                     ("bound_ms", bound_ms), ("library_ms", library_ms),
                     ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
            tot[k] += v
    source, replaces = KERNEL_ROWS[name]
    return {
        "name": f"{name}_bf16a", "route": "cuda", "source": source,
        "replaces": replaces, "wrapper": f"{name} with bf16 A",
        "launches": launches, "max_abs_err": max_abs, "ms": tot["ms"],
        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                     else "bytes"),
        "library_ms": tot["library_ms"],
        "per": f"one bf16 Llama prefill (batch {DEC_BATCH}, prompt "
               f"{PROMPT}, {LLAMA_LAYERS} layers): the sum over its "
               f"{len(calls)} bf16-A launches (layer 0's q, k and v; the "
               f"residual stream is f32 after the first attention, as JAX "
               f"promotes it); ms and library_ms replayed, plain_ms eager",
        "card": smi}


def _flips(got, ref) -> float:
    return float((got.argmax(-1) != ref.argmax(-1)).float().mean())


def _w8a8_other_seed(family: str, cfg, seed: int) -> dict:
    """W8A8 against fp32 on weights and prompts drawn from `seed`: the
    prefill graph Generator builds, as Engine(g) and as the bf16 Engine
    of quantize_matmuls_w8a8(g) (what prefill_dtype="w8a8" runs)."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models import decoder_family
    from onnx_rusty_inference_engine_tpu_torch.quant import (
        quantize_matmuls_w8a8)

    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (DEC_BATCH, PROMPT))
    dev_feed = {"input_ids": torch.as_tensor(prompts, device="cuda")}
    g = P.import_model(decoder_family(family)[0](
        cfg, batch=DEC_BATCH, seq_len=PROMPT, seed=seed, with_presents=True))
    out = {}
    for name, graph, dtype in (("fp32", g, "float32"),
                               ("w8a8", quantize_matmuls_w8a8(g),
                                "bfloat16")):
        eng = P.Engine(graph, dtype=dtype)
        with torch.no_grad():
            out[name] = eng(dev_feed)["logits"].float()
        del eng
        torch.cuda.empty_cache()
    return {"seed": seed,
            "rel_err_vs_fp32": _rel_err(out["w8a8"], out["fp32"]),
            "top1_flips_vs_fp32": _flips(out["w8a8"], out["fp32"])}


def _precision_decoder(family: str, cfg, smi: str, ort: bool = False):
    """Prefill through Generator(prefill_dtype=...) in fp32, bf16 and W8A8,
    each without and with int4_weights, then PREC_STEPS decode steps:
    prefill tokens/s (replayed), logits against fp32 (rel and top-1
    flips). Llama (ort=True) also: the bf16 prefill's int4 launches with
    bf16 A, planar and (weights in the ORT layout) interleaved. Returns
    {kernel row name: row}."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qmatmul_int4 as q4)

    prompts = _decode_prompts(cfg)
    dev_feed = {"input_ids": torch.as_tensor(prompts, device="cuda")}
    tokens = DEC_BATCH * PROMPT
    res, rows = {}, {}
    ref = None
    for pd in ("float32", "bfloat16", "w8a8"):
        for int4 in (False, True):
            if pd == "float32" and int4:
                continue  # the fp32 + int4 prefill: phases 6 and 18
            t0 = time.perf_counter()
            gen = _generator(cfg, family=family, prefill_dtype=pd,
                             int4_weights=int4)
            build_s = time.perf_counter() - t0
            key = pd + ("+int4" if int4 else "")
            n_mi = sum(n.op_type == "MatMulInteger"
                       for n in gen.prefill.graph.nodes)
            n4 = sum(n.op_type == "MatMulNBits"
                     for n in gen.prefill.graph.nodes)
            require((n_mi > 0) == (pd == "w8a8")
                    and (n4 > 0) == (int4 and pd != "w8a8"),
                    f"{family} {key}: prefill graph {n_mi} MatMulInteger, "
                    f"{n4} MatMulNBits")
            reset_counts()
            with torch.no_grad():
                logits = gen.prefill(dev_feed)["logits"].float()
            counts, a_dt = read_counts(), read_splits(
                "qmatmul_int4_planar").get("a_dtypes", {})
            require(counts["qmatmul_int8"] == n_mi
                    and counts["qmatmul_int4_planar"] == n4,
                    f"{family} {key}: one launch per MatMulInteger and per "
                    f"MatMulNBits: {counts}")
            require(bool(torch.isfinite(logits).all()), f"{key} logits")
            ms = _replayed_ms(gen.prefill, dev_feed)
            if ref is None:
                ref = logits
            r = {"prefill_tokens_per_s": tokens / ms * 1e3,
                 "prefill_ms": ms, "build_s": build_s,
                 "launches": {k: v for k, v in counts.items() if v},
                 "int4_a_dtypes": a_dt}
            if not int4:  # where a prefill's device time goes, by op type
                r["ops_ms"] = _ms_by_op(gen.prefill, dev_feed, 2)[0]
            if pd != "float32":
                r["rel_err_vs_fp32"] = _rel_err(logits, ref)
                r["top1_flips_vs_fp32"] = _flips(logits, ref)
            toks, _ = gen.generate(prompts, PREC_STEPS)
            require(toks.shape == (DEC_BATCH, PREC_STEPS) and toks.min() >= 0
                    and toks.max() < cfg.vocab_size, f"{key} decode steps")
            r["tokens_row0"] = toks[0].tolist()
            if ort and pd == "bfloat16" and int4:
                rows["qmatmul_int4_planar_bf16a"] = _bf16a_row(
                    "qmatmul_int4_planar",
                    _bf16a_calls(gen.prefill, dev_feed, True),
                    a_dt.get("bfloat16", 0), smi)
            if ort and pd == "bfloat16" and not int4:
                # the same bf16 prefill on ORT-layout int4 weights (the
                # prefill graph alone: packing the decode graph's too
                # would add a second pass over a billion weights)
                gen._engines(ort_int4_weights(gen.prefill.graph),
                             gen.decode.graph)
                reset_counts()
                with torch.no_grad():
                    ort_logits = gen.prefill(dev_feed)["logits"].float()
                counts = read_counts()
                a_ort = read_splits("qmatmul_int4_bf16")["a_dtypes"]
                require(a_ort["bfloat16"] > 0 and counts[
                    "qmatmul_int4_bf16"] == sum(a_ort.values()),
                    f"ORT-layout bf16 prefill: {counts} {a_ort}")
                r["ort_layout_int4"] = {
                    "launches": counts["qmatmul_int4_bf16"],
                    "a_dtypes": a_ort,
                    "rel_err_vs_fp32": _rel_err(ort_logits, ref),
                    "prefill_ms": _replayed_ms(gen.prefill, dev_feed)}
                rows["qmatmul_int4_bf16_bf16a"] = _bf16a_row(
                    "qmatmul_int4_bf16",
                    _bf16a_calls(gen.prefill, dev_feed, False),
                    a_ort["bfloat16"], smi)
            res[key] = r
            del gen
            torch.cuda.empty_cache()
    for int4 in ("", "+int4"):
        if "bfloat16" + int4 not in res:
            continue
        q, bf = res["w8a8" + int4], res["bfloat16" + int4]
        require(q["rel_err_vs_fp32"] < PREFILL_W8A8_REL[family]
                and q["top1_flips_vs_fp32"] <= bf["top1_flips_vs_fp32"]
                + PREFILL_FLIPS_OVER_BF16,
                f"{family} W8A8{int4} prefill against fp32: {q} (bf16 {bf})")
    other = None
    if family == "llama":  # a second draw of the error Llama is held to
        other = _w8a8_other_seed(family, cfg, 1)
        require(other["rel_err_vs_fp32"] < PREFILL_W8A8_REL[family],
                f"{family} W8A8 prefill against fp32, seed 1: {other}")
    emit({"phase": "precision", "model": family, "layers": cfg.n_layer,
          "batch": DEC_BATCH,
          "prompt": PROMPT, "decode_steps": PREC_STEPS,
          "bounds": {"w8a8_rel": PREFILL_W8A8_REL[family],
                     "w8a8_flips_over_bf16": PREFILL_FLIPS_OVER_BF16},
          "schemes": res, "w8a8_other_seed": other, "card": smi})
    return rows


def _precision_server(smi: str) -> None:
    """DecodeServer(prefill_dtype="w8a8") on GPT-2 124M's widths
    (GPT2_SIDE_LAYERS layers; 8 slots, buckets 16/32/64, fp32 decode): tokens/s over SERVE_REQS requests after a
    warm-up per bucket. Then a second such server, started with SERVE_REQS
    requests already queued in two waves of SERVE_SLOTS, each wave one
    bucket length (PREC_WAVES): a wave fills slots 0..7 in one admission
    pass and its rows step together from one position, as the rows of an
    isolated Generator(batch=SERVE_SLOTS, prefill_dtype="w8a8") do; every
    served token equals that Generator's on the wave's prompts."""
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
    from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer

    cfg = GPT2Config(n_layer=GPT2_SIDE_LAYERS)
    prompts = _serve_requests(cfg)
    new = PREC_SERVE_NEW

    def server():
        return DecodeServer(cfg, slots=SERVE_SLOTS,
                            prompt_len=SERVE_BUCKETS[-1], max_len=MAX_LEN,
                            prompt_buckets=SERVE_BUCKETS,
                            prefill_dtype="w8a8", autostart=False)

    srv = server()
    warm = [srv.submit(p[:b], 2) for p, b in zip(prompts, SERVE_BUCKETS)]
    srv.start()
    for f in warm:
        f.result(timeout=600)
    reset_counts()
    t0 = time.perf_counter()
    outs = [f.result(timeout=600)
            for f in [srv.submit(p, new) for p in prompts]]
    wall = time.perf_counter() - t0
    counts = read_counts()
    srv.stop()
    del srv
    torch.cuda.empty_cache()
    require(all(len(o) == new for o in outs), "served W8A8 tokens")
    require(counts["qmatmul_int8"] > 0
            and counts["qmatmul_int8"] % (4 * cfg.n_layer + 1) == 0,
            f"the W8A8 prefills' MatMulIntegers: {counts}")
    rng = np.random.default_rng(2)
    waves = [rng.integers(0, cfg.vocab_size, (SERVE_SLOTS, n))
             for n in PREC_WAVES]
    srv = server()
    futs = [srv.submit(p, new) for w in waves for p in w]
    srv.start()
    served = [np.asarray(f.result(timeout=600)) for f in futs]
    srv.stop()
    del srv
    torch.cuda.empty_cache()
    for i, w in enumerate(waves):
        g = Generator(cfg, batch=SERVE_SLOTS, prompt_len=w.shape[1],
                      max_len=MAX_LEN, prefill_dtype="w8a8")
        want = g.generate(w, new)[0]
        got = np.stack(served[i * SERVE_SLOTS:(i + 1) * SERVE_SLOTS])
        require(np.array_equal(got, want),
                f"wave {i} (prompt {w.shape[1]}): served tokens equal an "
                f"isolated W8A8 Generator's; rows agreeing "
                f"{(got == want).mean(axis=1).tolist()}")
        del g
        torch.cuda.empty_cache()
    emit({"phase": "precision", "server": "DecodeServer",
          "model": f"{GPT2_SIDE}, prefill_dtype w8a8, fp32 "
                   "decode", "slots": SERVE_SLOTS, "requests": SERVE_REQS,
          "new_tokens": new, "prompt_buckets": SERVE_BUCKETS,
          "served_tokens_per_s": SERVE_REQS * new / wall, "wall_s": wall,
          "launches": counts, "waves_prompt_len": list(PREC_WAVES),
          "waves_equal_isolated_generator": True, "card": smi})


PREC_SERVE_NEW = 16
PREC_WAVES = (64, 32)   # prompt lengths of the two held waves (buckets)


def phase_precision(smi: str) -> list:
    """The bf16 dtype policy and dynamic W8A8 on the card: BERT-base,
    GPT-2 124M and Llama prefill, the W8A8 DecodeServer. Returns the
    kernels line's new rows."""
    from onnx_rusty_inference_engine_tpu_torch.models import host_memo
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
    from onnx_rusty_inference_engine_tpu_torch.models.llama import (
        LlamaConfig)

    t0 = time.perf_counter()
    rows = [_precision_bert(smi)]
    _precision_decoder("gpt2", GPT2Config(n_layer=GPT2_SIDE_LAYERS), smi)
    with host_memo():
        bf16a = _precision_decoder("llama", LlamaConfig(n_layer=LLAMA_LAYERS),
                                   smi, ort=True)
    rows += [bf16a["qmatmul_int4_planar_bf16a"],
             bf16a["qmatmul_int4_bf16_bf16a"]]
    _precision_server(smi)
    emit({"phase": "precision_done", "seconds": time.perf_counter() - t0})
    return rows


def phase_vision(smi: str):
    """The vision slice: goldens, the three models, served ResNet-50 INT8,
    the CLI. Returns (each int8 kernel's sums by model, for the kernels
    line's `vision_path`; the grouped conv's row)."""
    t0 = time.perf_counter()
    phase_vision_goldens()
    paths = {}
    for name in VISION:
        rows, eng8 = phase_vision_model(name, smi)
        for k, v in rows.items():
            paths.setdefault(k, {})[name] = v
        if name == "resnet50":
            phase_serve_resnet(eng8, smi)
        del eng8, rows
        torch.cuda.empty_cache()
    phase_vision_cli(smi)
    emit({"phase": "vision_done", "seconds": time.perf_counter() - t0})
    g = paths.pop("qconv_grouped_int8_requant")["mobilenetv2"]
    source, replaces = KERNEL_ROWS["qconv_grouped_int8_requant"]
    grouped = {
        "name": "qconv_grouped_int8_requant", "route": "cuda",
        "source": source, "replaces": replaces, "launches": g["launches"],
        "max_abs_err": g["max_abs_err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "library": "F.conv2d f32 channels-last, groups=C: an f32 conv, "
                   "not an int8 one (no PyTorch call takes int8 here)",
        "per": "one INT8 MobileNetV2 forward at 224x224, b256: ms, "
               "plain_ms, bound_ms and library_ms sum its 17 depthwise "
               "convs; ms and library_ms are device times (CUDA-graph "
               "replay), plain_ms one eager call",
        "distinct_shapes": g["distinct_shapes"], "card": smi}
    emit({"phase": "grouped_conv", "kernel": "qconv_grouped_int8_requant",
          "model": "mobilenetv2", "per_forward": g["per_forward"],
          "ms": g["ms"], "gb_per_s": g["gb_per_s"],
          "bound_ms": g["bound_ms"], "share_of_bound": g["bound_ms"] / g["ms"],
          "library_ms": g["library_ms"],
          "first_design_recorded_ms": GROUPED_FIRST_DESIGN_MS,
          "over_first_design": GROUPED_FIRST_DESIGN_MS / g["ms"],
          "card": smi})
    return paths, grouped


# --------------------------------------------------------------------------
# ONNX Runtime's QOperator INT8 files
# --------------------------------------------------------------------------
# model -> (input, logits, launches per forward of either form)
QOP = {
    "squeezenet": ("data_0", "pool10_1", {"qconv_int8_requant": 26}),
    "mobilenetv2": ("input", "logits",
                    {"qconv_int8_requant": 35,
                     "qconv_grouped_int8_requant": 17, "qmatmul_int8": 1}),
}
QOP_FORMS = ("uint8", "int8")  # ORT's QUInt8 and QInt8 activation types
QOP_ITERS = 5                  # replayed forwards per Engine and form
QOP_HELD_OUT = 64              # images the CLI's quantizers are scored on

# the kernel wrappers the QOperator emitters call, by name in
# ops/quantized.py -> their plain versions
_QOP_WRAPPERS = {
    "qconv_int8_requant": ("qconv_int8", "qconv_int8_requant_plain"),
    "qconv_int8": ("qconv_int8", "qconv_int8_plain"),
    "qconv_grouped_int8_requant": ("qconv_grouped_int8",
                                   "qconv_grouped_int8_requant_plain"),
    "qconv_grouped_int8": ("qconv_grouped_int8", "qconv_grouped_int8_plain"),
    "qmatmul_int8_requant": ("qmatmul_int8", "qmatmul_int8_requant_plain"),
    "qmatmul_int8": ("qmatmul_int8", "qmatmul_int8_plain"),
}


def _wrapper_and_plain(name: str):
    """A kernel wrapper the QOperator emitters call, and its plain
    version."""
    import importlib

    mod, plain = _QOP_WRAPPERS[name]
    m = importlib.import_module(f"{PKG}.ops.kernels.{mod}")
    return getattr(m, name), getattr(m, plain)


@contextlib.contextmanager
def _recorded_kernel_calls(calls: list):
    """Every kernel wrapper call of the QOperator emitters, recorded as
    (wrapper, args, kwargs, output): the card's own operands of each node's
    kernel launch."""
    from onnx_rusty_inference_engine_tpu_torch.ops import quantized

    real = {k: getattr(quantized, k) for k in _QOP_WRAPPERS}

    def recorder(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return call

    for k in real:
        setattr(quantized, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in real.items():
            setattr(quantized, k, fn)


def _qop_call_key(name, args, kw):
    """What a recorded call's timing depends on: the wrapper, its operand
    shapes and types, and its geometry and zero-point arguments."""
    shapes = tuple((tuple(a.shape), str(a.dtype)) for a in args
                   if isinstance(a, torch.Tensor) and a.dim() >= 2)
    geo = tuple((k, str(v)) for k, v in sorted(kw.items())
                if k not in ("packed",))
    return name, shapes, geo


def _qop_kernel_work(name, args, kw, out):
    """(operations, bytes) a recorded call needs: 2 x MACs over in-bounds
    taps (a padding tap holds the zero point, so every tap counts), each
    input read once, the output written once."""
    if name.startswith("qmatmul"):
        a, b = args[0], args[1]
        M, K = a.shape
        N = b.shape[1]
        return 2 * M * N * K, (M * K + K * N + out.numel()
                               * out.element_size() + 8 * N)
    x, w = args[0], args[1]  # a conv of any rank: w [O, Cg, kernel...]
    macs = out.numel() * int(np.prod(w.shape[1:]))
    return 2 * macs, (x.numel() + w.numel() + 8 * w.shape[0]
                      + out.numel() * out.element_size())


# wrapper -> the kernel (counter and kernels-line row) it launches
_QOP_KERNEL = {"qconv_int8_requant": "qconv_int8_requant",
               "qconv_int8": "qconv_int8_requant",
               "qconv_grouped_int8_requant": "qconv_grouped_int8_requant",
               "qconv_grouped_int8": "qconv_grouped_int8_requant",
               "qmatmul_int8_requant": "qmatmul_int8",
               "qmatmul_int8": "qmatmul_int8"}

# what each QOperator run's kernel instances are: the file's form, or the
# ConvInteger node
QOP_LABELS = {"uint8": "QUInt8: uint8 x, zero points",
              "int8": "QInt8: int8 x, zero points",
              "convinteger": "ConvInteger: int32 epilogue, uint8 x, "
                             "zero points"}


def _qop_library(name, args, kw):
    """torch._int_mm, PyTorch's int8 product (int32 out, no bias, requant or
    zero point), on a recorded call's operands where the call is one: a
    1x1, stride-1, unpadded conv or a GEMM of int8 by int8 with M > 16 and
    K, N multiples of 8 (_int_mm's shapes); else None."""
    a, w = args[0], args[1]
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        return None
    if name == "qconv_int8_requant":
        if (w.shape[2:] != (1, 1) or tuple(kw.get("stride", (1, 1)))
                != (1, 1) or any(p for side in kw.get("padding", ())
                                 for p in side)):
            return None
        a = a.permute(0, 2, 3, 1).reshape(-1, a.shape[1])
        b = w.reshape(w.shape[0], w.shape[1])
    elif name == "qmatmul_int8_requant":
        b = w.t().contiguous()  # column-major B, as _int_mm wants it
    else:
        return None
    M, K = a.shape
    if M <= 16 or K % 8 or b.shape[0] % 8:
        return None
    return graph_ms(lambda: torch._int_mm(a, b.t()), ITERS)


def _qop_no_library(kernel: str, label: str) -> str:
    """Why a row of kernel instances has no library time."""
    if label.startswith(("QUInt8", "ConvInteger")):
        return ("none: torch._int_mm, PyTorch's one int8 product, takes an "
                "int8 A, not a uint8 x, and no PyTorch call pads with a "
                "zero point")
    if kernel == "qconv_grouped_int8_requant":
        return "none: PyTorch has no int8 grouped conv"
    return "none: PyTorch has no int8 conv"


def _qop_lines(model: str, form: str, calls: list, counts: dict,
               forwards: int, smi: str) -> dict:
    """Each recorded call bit-equal to its plain version on the card's own
    operands; then one kernel line per distinct call (kernel, plain and
    library times, bound), and the sums per kernel over one forward.
    `counts` are the launches of the main path's run of this form, read
    from the wrappers' counters: each kernel's row takes its launches from
    there, after checking them against the calls of one forward x
    `forwards`."""
    tot = {}
    timed = {}
    for name, args, kw, out in calls:
        kern, plain = _wrapper_and_plain(name)
        pkw = {k: v for k, v in kw.items() if k != "packed"}
        want = plain(*args, **pkw)
        err = int((out.int() - want.int()).abs().max()) if out.numel() else 0
        require(torch.equal(out, want), f"qoperator {model} {form}: {name} "
                f"== plain on the card's operands (max |diff| {err})")
        key = _qop_call_key(name, args, kw)
        if key not in timed:
            ms = graph_ms(lambda: kern(*args, **kw), ITERS)
            _, plain_ms = _timed(lambda: plain(*args, **pkw))
            library_ms = _qop_library(name, args, kw)
            ops, nbytes = _qop_kernel_work(name, args, kw, out)
            bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                         INT8_OPS_PER_S)
            timed[key] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "ops_ms": ops_ms, "bytes_ms": bytes_ms}
            emit({"phase": "kernel", "kernel": name, "path": "qoperator",
                  "model": model, "form": form, "instance": QOP_LABELS[form],
                  "shapes": [list(a.shape) for a in args
                             if isinstance(a, torch.Tensor)
                             and a.dim() >= 2],
                  "args": {k: str(v) for k, v in kw.items()
                           if k != "packed"},
                  "equal": True, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
                  "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
                  "card": smi})
        t = timed[key]
        kern = tot.setdefault(_QOP_KERNEL[name], dict.fromkeys(
            ("per_forward", "ms", "plain_ms", "bound_ms", "ops_ms",
             "bytes_ms", "library_ms", "ms_same_shapes_as_library",
             "with_library"), 0.0))
        kern["per_forward"] += 1
        for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
            kern[k] += t[k]
        if t["library_ms"] is not None:
            kern["with_library"] += 1
            kern["library_ms"] += t["library_ms"]
            kern["ms_same_shapes_as_library"] += t["ms"]
    require({k: int(v["per_forward"]) * forwards for k, v in tot.items()}
            == {k: v for k, v in counts.items() if v},
            f"qoperator {model} {form}: the calls of one forward x "
            f"{forwards} forwards against the main path's launches {counts}")
    for kernel, v in tot.items():
        v["launches"] = counts[kernel]
        v["bound_by"] = ("operations" if v.pop("ops_ms") >= v.pop("bytes_ms")
                         else "bytes")
        n, k = int(v["per_forward"]), int(v.pop("with_library"))
        if k == 0:
            v["library_ms"] = v["ms_same_shapes_as_library"] = None
            v["library"] = _qop_no_library(kernel, QOP_LABELS[form])
        else:
            v["library"] = ("torch._int_mm (int32 out, no bias, requant or "
                            "zero point)")
            if k < n:
                v["library"] += (f" over the {k} of its {n} calls a forward "
                                 f"that are 1x1 int8 products; "
                                 + _qop_no_library(kernel, QOP_LABELS[form])
                                 + " for the other "
                                 f"{n - k}")
    return tot


def phase_qoperator_model(model: str, smi: str) -> dict:
    """One CNN at 224x224, b256, in ONNX Runtime's QOperator form, both
    activation types, through the port's entry points: calibrate on x[:8],
    the QUInt8 and QInt8 files (tests/torch_port_qoperator.py, as ONNX
    bytes), one Engine each (every forward a captured graph). Counts set
    to 0 just before, read just after: the launches per forward, per form.
    Then every kernel call of an eager forward of each file bit-equal to its
    plain version on the card's own operands (the kernel lines); the QUInt8
    forward, every quantized tensor less 128, equal to the QInt8 one; INT8
    against fp32 at the bounds of the symmetric INT8 phases; images/s and
    device ms by op type. Returns the instances' sums."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_qoperator import qoperator_graph, reparsed

    inp, logits, per_forward = QOP[model]
    t0 = time.perf_counter()
    graph = P.import_model({"squeezenet": P.build_squeezenet,
                            "mobilenetv2": P.build_mobilenetv2}[model]())
    x = np.random.default_rng(0).standard_normal(
        (BATCH, 3, 224, 224)).astype(np.float32)
    feed = {inp: x}
    dev_feed = {inp: torch.as_tensor(x, device="cuda")}
    with torch.no_grad():
        y32 = P.lower(probe_graph(graph, [logits]), "cuda")(
            P.Engine(graph).params, dev_feed)[logits].float()

    # the main path, counted per form
    ranges = P.calibrate(graph, [{inp: x[:CALIB]}])
    graphs = {f: reparsed(qoperator_graph(graph, ranges, f))
              for f in QOP_FORMS}
    engines, ys, ms, counts, splits = {}, {}, {}, {}, {}
    for f, g in graphs.items():
        reset_counts()
        engines[f] = P.Engine(g)
        ys[f] = engines[f](feed)[logits]
        ms[f] = cuda_ms(lambda: engines[f](dev_feed), QOP_ITERS, 1)
        counts[f] = {k: v for k, v in read_counts().items() if v}
        splits[f] = {k: read_splits(k) for k in counts[f]}
    main_s = time.perf_counter() - t0
    forwards = 2 + QOP_ITERS  # the first call, a warm-up, the timed ones
    for f in QOP_FORMS:
        require(counts[f] == {k: n * forwards
                              for k, n in per_forward.items()},
                f"qoperator {model} {f}: {per_forward} launches per "
                f"forward over {forwards} forwards: {counts[f]}")
        n_u8 = counts[f]["qconv_int8_requant"] if f == "uint8" else 0
        require(splits[f]["qconv_int8_requant"]["forms"]["uint8_x"] == n_u8,
                f"qoperator {model} {f}: uint8 A on the QUInt8 convs only: "
                f"{splits[f]}")
        if model == "squeezenet":
            require(splits[f]["qconv_int8_requant"]["producers"]
                    == {k: n * forwards
                        for k, n in SQUEEZENET_PRODUCERS.items()},
                    f"qoperator {model} {f}: {SQUEEZENET_PRODUCERS} a "
                    f"forward by A producer: {splits[f]}")
        # the stem (conv1) as its space-to-depth rewrite, once a forward
        require(splits[f]["qconv_int8_requant"]["forms"]["s2d"] == forwards,
                f"qoperator {model} {f}: the stem in the s2d form once a "
                f"forward: {splits[f]}")
    for t in ys.values():
        require(tuple(t.shape)[:2] == (BATCH, 1000)
                and bool(torch.isfinite(t).all()),
                f"qoperator {model}: logits {tuple(t.shape)}")

    # every kernel call on the card's own operands, and the twins
    calls, rows, card = {}, {}, {}
    for f, g in graphs.items():
        calls[f] = []
        names = [o for n in g.nodes for o in n.outputs]
        with torch.no_grad(), _recorded_kernel_calls(calls[f]):
            card[f] = P.lower(probe_graph(g, names), "cuda",
                              engines[f].packed)(engines[f].params,
                                                 dev_feed)
        rows[f] = _qop_lines(model, f, calls[f], counts[f], forwards, smi)
    n_q = 0
    for name, v in card["uint8"].items():
        w = card["int8"][name]
        if v.dtype == torch.uint8:
            n_q += 1
            v = (v.to(torch.int16) - 128).to(torch.int8)
        require(torch.equal(v, w), f"qoperator {model}: QUInt8 {name} less "
                f"128 == QInt8")
    require(torch.equal(ys["uint8"], ys["int8"]),
            f"qoperator {model}: QUInt8 logits == QInt8 logits")
    del card

    # INT8 against fp32, at the symmetric INT8 phases' bounds
    y8 = ys["uint8"].float().reshape(BATCH, -1)
    y32 = y32.reshape(BATCH, -1)
    top1 = float((y8.argmax(1) == y32.argmax(1)).float().mean())
    rel = float((y8 - y32).abs().max() / y32.abs().max())
    soft = float((y8.softmax(1) - y32.softmax(1)).abs().max())
    if model == "squeezenet":
        ok, bound_s = top1 == 1.0 or rel < 0.1, "top-1 equal or rel < 0.1"
    else:
        ok, bound_s = (top1 == 1.0 or soft < 0.15,
                       "top-1 equal or max |softmax d| < 0.15")
    by_op = _ms_by_op(engines["uint8"], dev_feed, 3)[0]
    emit({"phase": "qoperator", "model": model, "size": "224x224",
          "batch": BATCH, "main_path_s": main_s, "forwards": forwards,
          "images_per_s": {f: BATCH / ms[f] * 1e3 for f in QOP_FORMS},
          "launches": counts, "launches_per_forward": per_forward,
          "splits": splits,
          "kernel_calls_equal_plain": {f: len(c) for f, c in calls.items()},
          "uint8_tensors_equal_int8_plus_128": n_q,
          "int8_vs_fp32": {"top1_agreement": top1,
                           "max_abs_over_max_ref": rel,
                           "max_abs_softmax": soft, "bound": bound_s},
          "ms_by_op_uint8": by_op, "instances": rows, "card": smi})
    require(ok, f"qoperator {model}: INT8 against fp32 ({bound_s}): top-1 "
            f"{top1}, rel {rel}, softmax {soft}")
    del engines, calls
    torch.cuda.empty_cache()
    return rows


def phase_qoperator_cli(smi: str) -> dict:
    """The CLI as subprocesses on SqueezeNet 1.0 (224x224): `quantize
    --calibration mse --bias-correct` and plain minmax `quantize` on an
    8-image calibration file, then `run` on each written file against the
    fp32 golden; then both files' mean |INT8 - fp32| of the logits on
    QOP_HELD_OUT other images, in-process: mse + bias correction must be
    the smaller, as tests/test_quant.py holds bias correction in JAX."""
    import tempfile

    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.debug import probe_graph

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    calib = rng.standard_normal((CALIB, 3, 224, 224)).astype(np.float32)
    held = rng.standard_normal((QOP_HELD_OUT, 3, 224, 224)).astype(
        np.float32)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        model = os.path.join(d, "squeezenet.onnx")
        onnx_io.save_model(model, P.build_squeezenet())
        onnx_io.write_tensor_file(os.path.join(d, "calib.pb"), "data_0",
                                  calib)
        onnx_io.write_tensor_file(os.path.join(d, "in.pb"), "data_0",
                                  held[:1])
        fp32 = P.Engine(P.import_onnx(model))
        onnx_io.write_tensor_file(os.path.join(d, "out.pb"), "softmaxout_1",
                                  fp32.run({"data_0": held[:1]})[
                                      "softmaxout_1"])
        files = {"mse_bias_correct": ["--calibration", "mse",
                                      "--bias-correct"],
                 "minmax": []}
        # both quantizers at once, then both runs at once: no timed step
        procs = {f"quantize_{k}": _cli(
            "quantize", "--model", model, "--out",
            os.path.join(d, f"{k}.onnx"), "--calib-input",
            os.path.join(d, "calib.pb"), *flags)
            for k, flags in files.items()}
        res = {k: _finish(p) for k, p in procs.items()}
        procs = {f"run_{k}": _cli(
            "run", "--model", os.path.join(d, f"{k}.onnx"), "--input",
            os.path.join(d, "in.pb"), "--golden",
            os.path.join(d, "out.pb"), "--rtol", "1", "--atol", "1")
            for k in files}
        res.update({k: _finish(p) for k, p in procs.items()})
        for k, (rc, out, err) in res.items():
            require(rc == 0, f"cli {k} exited {rc}: {err[-2000:]}")
        dev = {"data_0": torch.as_tensor(held, device="cuda")}
        with torch.no_grad():
            ref = P.lower(probe_graph(fp32.graph, ["pool10_1"]), "cuda")(
                fp32.params, dev)["pool10_1"]
            err = {}
            for k in files:
                e = P.Engine(P.import_onnx(os.path.join(d, f"{k}.onnx")))
                got = P.lower(probe_graph(e.graph, ["pool10_1"]), "cuda",
                              e.packed)(e.params, dev)["pool10_1"]
                err[k] = float((got.float() - ref).abs().mean())
    line = {"phase": "qoperator_cli",
            "quantize": {k: json.loads(res[f"quantize_{k}"][1])
                         for k in files},
            "run": {k: res[f"run_{k}"][1].strip().splitlines()[-1]
                    for k in files},
            "mean_abs_err_logits": err, "held_out_images": QOP_HELD_OUT,
            "seconds": time.perf_counter() - t0, "card": smi}
    emit(line)
    require(err["mse_bias_correct"] < err["minmax"],
            f"cli: mse + bias correction's mean error {err}")
    return line


def phase_qoperator(smi: str) -> list:
    """The QOperator slice: both models in both forms, a ConvInteger node
    on the int32 epilogue, the CLI; the kernels line's rows of the new
    instances."""
    t0 = time.perf_counter()
    per_model = {m: phase_qoperator_model(m, smi) for m in QOP}
    convint = phase_convinteger(smi)
    phase_qoperator_cli(smi)
    emit({"phase": "qoperator_done", "seconds": time.perf_counter() - t0})
    return _qop_rows(per_model, convint, smi)


def phase_convinteger(smi: str) -> dict:
    """ConvInteger (ORT's quantize_dynamic conv) through an Engine: one node
    at SqueezeNet fire2's expand3x3 shape (b256, 16 -> 64 channels at
    54x54, pad 1), uint8 x with zero point 131 against int8 weights with a
    per-channel zero point, on the conv kernel's int32 epilogue (and its
    window sums); exact against the plain versions on the card's operands.
    Counts set to 0 just before, read just after."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.graph import (Graph,
                                                             InputSpec, Node)

    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (BATCH, 16, 54, 54)).astype(np.uint8)
    w = rng.integers(-127, 128, (64, 16, 3, 3)).astype(np.int8)
    wzp = rng.integers(-3, 4, (64,)).astype(np.int8)
    g = Graph(name="convinteger", nodes=[Node(
        "ConvInteger", ["x", "w", "xzp", "wzp"], ["y"], "fire2_expand3x3",
        {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]})],
        constants={"w": w, "xzp": np.uint8(131), "wzp": wzp},
        inputs=[InputSpec("x", x.shape, np.dtype(np.uint8))],
        outputs=["y"], opset=13, weight_names=["w"])
    eng = P.Engine(g)
    dev = {"x": torch.as_tensor(x, device="cuda")}
    reset_counts()
    y = eng(dev)["y"]
    ms = cuda_ms(lambda: eng(dev), QOP_ITERS, 1)
    counts = {k: v for k, v in read_counts().items() if v}
    forwards = 2 + QOP_ITERS
    require(counts == {"qconv_int8_requant": 2 * forwards}
            and read_splits("qconv_int8_requant")["epilogues"]["int32"]
            == 2 * forwards,
            f"ConvInteger: 2 int32 launches a forward: {counts}")
    calls = []
    with torch.no_grad(), _recorded_kernel_calls(calls):
        y2 = P.lower(g, "cuda", eng.packed)(eng.params, dev)["y"]
    require(torch.equal(y, y2) and y.dtype == torch.int32,
            "ConvInteger eager == replayed")
    rows = _qop_lines("convinteger", "convinteger", calls, counts,
                      forwards, smi)
    emit({"phase": "convinteger", "ms": ms, "launches": counts,
          "instances": rows, "card": smi})
    return rows


def _qop_rows(per_model: dict, convint: dict, smi: str) -> list:
    """The kernels line's rows of this slice's new instances, one per
    kernel and QOperator form (QOP_LABELS), each with the per-forward sums
    of its first model, and the others in `qoperator_path`; `launches`
    sums the main path's counts of every model's run of that form."""
    merged = {}
    for model, forms in per_model.items():
        for form, kernels in forms.items():
            for kname, v in kernels.items():
                merged.setdefault((kname, QOP_LABELS[form]), {})[
                    f"{model} {form}"] = v
    for kname, v in convint.items():
        merged[(kname, QOP_LABELS["convinteger"])] = {"convinteger": v}
    out = []
    for (kname, label), paths in merged.items():
        source, replaces = KERNEL_ROWS[kname]
        first_path, first = next(iter(paths.items()))
        out.append({
            "name": kname, "instance": label, "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": sum(v["launches"] for v in paths.values()),
            "max_abs_err": 0, "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "library": first["library"],
            "ms_same_shapes_as_library": first["ms_same_shapes_as_library"],
            "per": f"one {first_path} forward (224x224, b256): the sums "
                   f"of its {int(first['per_forward'])} launches",
            "qoperator_path": paths, "card": smi})
    return out


# --------------------------------------------------------------------------
# export: the deployment artifact, loaded in a fresh process
# --------------------------------------------------------------------------
EXPORT_ITERS = 20   # replayed forwards timed per Engine and per artifact
EXPORT_REPS = 3     # replayed forwards whose launches are counted
# BERT-base's depth in this phase, at its full widths (the smoke's time
# limit: all 12 layers add ~60 s to the phase on an H100; phase 9 runs
# all 12)
EXPORT_BERT_LAYERS = 2
# GPT-2 124M's depth in this phase, at its full widths (the same limit;
# phase 6 and the decoding phase run all 12 layers)
EXPORT_GPT2_LAYERS = 2

# model -> (output checked for shape, per-second unit, launches per
# forward): the four Engines of the phase, each built the way a user
# would build it from an ONNX file (_export_pipeline)
EXPORT = {
    "squeezenet1.0 int8 b256": ("softmaxout_1", "images",
                                {"qconv_int8_requant": 26}),
    "mobilenetv2 int8 b256": ("output", "images",
                              {"qconv_int8_requant": 35,
                               "qconv_grouped_int8_requant": 17,
                               "qmatmul_int8": 1}),
    f"bert-base {EXPORT_BERT_LAYERS} of 12 layers int8 B32 T128": (
        "pooler_output", "sequences",
        {"qmatmul_int8": 6 * EXPORT_BERT_LAYERS + 1}),
    f"gpt2 124M {EXPORT_GPT2_LAYERS} of 12 layers int4 int8kv decode step "
    "b8": ("logits", "tokens",
           {"qmatmul_int4_planar": 4 * EXPORT_GPT2_LAYERS + 1,
            "decode_attention_int8": EXPORT_GPT2_LAYERS}),
}

# what a loaded artifact must not have imported
IMPORTER_MODULES = tuple(f"{PKG}.{m}" for m in ("onnx_io", "graph",
                                                "ops.registry"))


def _export_files(model: str, d: str) -> None:
    """Write the model's fp32 graph (random weights from seed 0) as
    d/model.onnx and its feed as d/feed.npz: SqueezeNet and MobileNetV2 at
    224x224, b256 (x from default_rng(0)); BERT-base at B 32, T 128 (phase
    9's feed) with EXPORT_BERT_LAYERS of its 12 layers; GPT-2 124M's
    INT8-KV, fused-attention decode step (EXPORT_GPT2_LAYERS of its 12
    layers) at batch 8 and max_len 256
    (phase 6's shapes), fed token ids, position 64 (a 64-token prompt)
    and random int8 caches and KV scales."""
    from onnx_rusty_inference_engine_tpu_torch import onnx_io

    rng = np.random.default_rng(0)
    if model.startswith(("squeezenet", "mobilenet")):
        import onnx_rusty_inference_engine_tpu_torch as P

        proto = (P.build_squeezenet() if model.startswith("squeezenet")
                 else P.build_mobilenetv2())
        x = rng.standard_normal((BATCH, 3, 224, 224)).astype(np.float32)
        feed = {"data_0" if model.startswith("squeezenet") else "input": x}
    elif model.startswith("bert"):
        from onnx_rusty_inference_engine_tpu_torch.models.bert import (
            BASE, build_bert)

        cfg = dataclasses.replace(BASE, n_layer=EXPORT_BERT_LAYERS)
        proto = build_bert(cfg, batch=BERT_BATCH, seq_len=BERT_SEQ, seed=0)
        feed = _bert_feed(BASE.vocab_size)
    else:
        from onnx_rusty_inference_engine_tpu_torch.models import (
            build_gpt2_decode)
        from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import (
            GPT2Config)

        cfg = GPT2Config(n_layer=EXPORT_GPT2_LAYERS)
        proto = build_gpt2_decode(cfg, batch=DEC_BATCH, max_len=MAX_LEN,
                                  kv_dtype="int8", fused_attention=True,
                                  seed=0)
        hd = cfg.n_embd // cfg.n_head
        feed = {"input_ids": rng.integers(0, cfg.vocab_size, (DEC_BATCH, 1)),
                "pos": np.full((DEC_BATCH,), PROMPT, dtype=np.int64)}
        for i in range(cfg.n_layer):
            for kind in ("key", "value"):
                feed[f"past_{kind}_{i}"] = rng.integers(
                    -127, 128, (DEC_BATCH, cfg.n_head, MAX_LEN, hd)
                ).astype(np.int8)
                feed[f"kv_scale_{kind}_{i}"] = (
                    rng.random(cfg.n_head) * 0.05 + 0.01).astype(np.float32)
    onnx_io.save_model(os.path.join(d, "model.onnx"), proto)
    np.savez(os.path.join(d, "feed.npz"), **feed)


def _export_pipeline(model: str, d: str):
    """(Engine, feed) as a user builds them from d/model.onnx: import_onnx,
    then calibrate and quantize_graph, or, for the decode step,
    quantize_weights_int4; then Engine on the card. The CNNs calibrate on
    their first CALIB images; BERT, whose graph bakes its batch into its
    Reshapes, on its whole feed (phase 9's B = 8 calibration graph would
    be a second file)."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.quant import (
        quantize_weights_int4)

    graph = P.import_onnx(os.path.join(d, "model.onnx"))
    feed = dict(np.load(os.path.join(d, "feed.npz")))
    if model.startswith("gpt2"):
        graph = quantize_weights_int4(graph)
    else:
        calib = ({k: v[:CALIB] for k, v in feed.items()}
                 if not model.startswith("bert") else feed)
        graph = P.quantize_graph(graph, ranges=P.calibrate(graph, [calib]))
    return P.Engine(graph), feed


def _replayed(run, feed, iters: int):
    """(per-forward device ms of `run` (an Engine or a loaded artifact,
    already warm) on device-resident inputs, by CUDA events around
    `iters` calls; launches per call, `"kernel|counter|variant"` ->
    count, over EXPORT_REPS calls; the device kernels of one profiled
    call, name -> [count, device ms])."""
    from torch.profiler import ProfilerActivity, profile

    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import counters

    dev = {k: torch.as_tensor(v, device="cuda") for k, v in feed.items()}
    with torch.no_grad():
        run(dev)
        torch.cuda.synchronize()
        before = counters.snapshot()
        for _ in range(EXPORT_REPS):
            run(dev)
        torch.cuda.synchronize()
        gains = {"|".join(k): n / EXPORT_REPS
                 for k, n in counters.delta(before).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run(dev)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(dev)
            torch.cuda.synchronize()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels[evt.key[:120]] = [evt.count, us / 1e3]
    return start.elapsed_time(end) / iters, gains, kernels


def _kernel_diff(a: dict, b: dict) -> dict:
    """The kernels whose count per call differs between two _replayed
    profiles: name -> [count in a, count in b]."""
    return {k: [a.get(k, [0])[0], b.get(k, [0])[0]]
            for k in sorted(set(a) | set(b))
            if a.get(k, [0])[0] != b.get(k, [0])[0]}


def export_child(argv) -> int:
    """`chip_smoke.py --export-child artifact|importer MODEL DIR`: a fresh
    process that runs d/feed.npz once through the loaded artifact (d/
    a.oriet.npz) or through the importer path (_export_pipeline) and prints
    one JSON line: the wall clock at its first output (synchronized),
    its outputs' file, and, for the artifact, the modules it imported,
    its replayed ms and launches per forward. The artifact child exits 3
    if it imported the ONNX codec, the graph or the op registry."""
    kind, model, d = argv
    t_main = time.time()  # the interpreter, numpy and torch imported
    sys.path.insert(0, HERE)
    torch.cuda.init()
    t_cuda = time.time()
    if kind == "artifact":
        from onnx_rusty_inference_engine_tpu_torch.export_aot import (
            load_exported)

        m = load_exported(os.path.join(d, "a.oriet.npz"))
        feed = dict(np.load(os.path.join(d, "feed.npz")))
    else:
        m, feed = _export_pipeline(model, d)
    t_ready = time.time()
    first = m(feed)
    torch.cuda.synchronize()
    t_first = time.time()
    out = {"first_output_at": t_first, "main_at": t_main, "cuda_at": t_cuda,
           "ready_at": t_ready,
           "dynamo_imported": "torch._dynamo" in sys.modules}
    if kind == "artifact":
        replayed = m(feed)
        np.savez(os.path.join(d, "artifact_out.npz"),
                 **{f"first:{k}": v.cpu().numpy() for k, v in first.items()},
                 **{f"replayed:{k}": v.cpu().numpy()
                    for k, v in replayed.items()})
        sys.stdin.readline()  # the importer child has exited: time alone
        out["ms"], out["launches_per_forward"], out["kernels"] = _replayed(
            m, feed, EXPORT_ITERS)
        out["load_split_s"] = m.load_split_s
        out["importer_modules"] = [n for n in IMPORTER_MODULES
                                   if n in sys.modules]
        out["jax_imported"] = any(n == "jax" or n.startswith("jax.")
                                  for n in sys.modules)
    print(json.dumps(out), flush=True)
    if kind == "artifact" and (out["importer_modules"]
                               or out["jax_imported"]):
        return 3
    return 0


def _children(model: str, d: str) -> dict:
    """Run export_child for the artifact and for the importer path, both
    fresh processes started together (their cold starts side by side, in
    the same conditions); the artifact child times its replays once the
    importer child has exited. kind -> its JSON line plus `cold_start_s`,
    from just before its process starts to its first output. A child that
    fails fails the phase; none outlives it."""
    kids = {}
    try:
        for kind in ("artifact", "importer"):
            t0 = time.time()
            kids[kind] = (t0, subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--export-child", kind, model, d], stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=HERE))
        return {kind: _child_result(model, kind, *kids[kind])
                for kind in ("importer", "artifact")}
    finally:
        for _, proc in kids.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _child_result(model: str, kind: str, t0: float,
                  proc: subprocess.Popen) -> dict:
    """One export_child's JSON line (the artifact child is let go on to
    its replays here) and where its cold start went."""
    rc, stdout, stderr = _finish(proc, "\n")
    require(rc == 0, f"{model}: the {kind} child exited {rc}:\n"
            f"{stdout[-2000:]}\n{stderr[-4000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    out["cold_start_s"] = out["first_output_at"] - t0
    # where the cold start went: process start and imports, CUDA's
    # context, loading (the artifact) or importing, quantizing and
    # building (the Engine), the first call (eager run and capture)
    out["cold_start_split_s"] = {
        "process_and_imports": out["main_at"] - t0,
        "cuda_init": out["cuda_at"] - out["main_at"],
        "load_or_build": out["ready_at"] - out["cuda_at"],
        "first_call": out["first_output_at"] - out["ready_at"]}
    return out


def phase_export_model(model: str, d: str, smi: str) -> dict:
    """One model: its Engine from the ONNX file; export_engine; the
    artifact run in a fresh process that imports no ONNX codec, graph or
    op registry; its outputs (first, eager, and replayed) equal the
    Engine's bit for bit; its launches per replayed forward equal the
    Engine's, kernel by kernel and split by split; cold starts of the
    artifact and of the importer path, each in a fresh process, the two
    started together; replayed throughput of both."""
    from onnx_rusty_inference_engine_tpu_torch.export_aot import (
        export_engine)

    out_name, unit, per_forward = EXPORT[model]
    t0 = time.perf_counter()
    _export_files(model, d)
    files_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng, feed = _export_pipeline(model, d)
    want = {k: v.cpu().numpy() for k, v in eng(feed).items()}
    build_s = time.perf_counter() - t0
    batch = int(next(iter(feed.values())).shape[0])
    require(want[out_name].shape[0] == batch
            and np.isfinite(want[out_name]).all(),
            f"{model}: {out_name} {want[out_name].shape} finite")
    eng_ms, eng_gains, eng_kernels = _replayed(eng, feed, EXPORT_ITERS)
    want_gains = {f"{k}|launches|": n for k, n in per_forward.items()}
    require({k: n for k, n in eng_gains.items() if k.endswith("|launches|")}
            == want_gains,
            f"{model}: Engine launches per forward {eng_gains}")
    art = os.path.join(d, "a.oriet.npz")
    t0 = time.perf_counter()
    export_engine(eng, feed, art)
    export_s = time.perf_counter() - t0
    with np.load(art) as z:
        weight_bytes = sum(z[k].nbytes for k in z.files
                           if k.startswith(("p:", "k:")))
        program_bytes = z["__exported__:cuda"].nbytes
    del eng
    torch.cuda.empty_cache()

    kids = _children(model, d)
    loaded, importer = kids["artifact"], kids["importer"]
    with np.load(os.path.join(d, "artifact_out.npz")) as z:
        for when in ("first", "replayed"):
            for k, v in want.items():
                got = z[f"{when}:{k}"]
                require(got.dtype == v.dtype and np.array_equal(got, v),
                        f"{model}: the artifact's {when} {k} equals the "
                        f"Engine's bit for bit")
    require(loaded["launches_per_forward"] == eng_gains,
            f"{model}: launches per replayed forward, artifact "
            f"{loaded['launches_per_forward']} vs Engine {eng_gains}")
    return {"phase": "export", "model": model, "batch": batch,
            "artifact_bytes": os.path.getsize(art),
            "weight_bytes": weight_bytes, "program_bytes": program_bytes,
            "export_s": export_s, "files_s": files_s,
            "engine_build_s": build_s,
            "cold_start_s": {"artifact": loaded["cold_start_s"],
                             "importer": importer["cold_start_s"]},
            "cold_starts_side_by_side": True,
            "cold_start_split_s": {
                "artifact": loaded["cold_start_split_s"],
                "importer": importer["cold_start_split_s"]},
            "artifact_load_split_s": loaded["load_split_s"],
            "dynamo_imported": {"artifact": loaded["dynamo_imported"],
                                "importer": importer["dynamo_imported"]},
            f"{unit}_per_s_replayed": {
                "artifact": batch / loaded["ms"] * 1e3,
                "engine": batch / eng_ms * 1e3},
            "ms_replayed": {"artifact": loaded["ms"], "engine": eng_ms},
            "artifact_over_engine": eng_ms / loaded["ms"],
            # one profiled replayed call each: device kernels and busy ms,
            # and the kernels whose count differs (artifact, Engine)
            "kernels_per_call": {
                "artifact": sum(n for n, _ in loaded["kernels"].values()),
                "engine": sum(n for n, _ in eng_kernels.values())},
            "busy_ms_per_call": {
                "artifact": sum(ms for _, ms in loaded["kernels"].values()),
                "engine": sum(ms for _, ms in eng_kernels.values())},
            "kernel_count_diff": _kernel_diff(loaded["kernels"],
                                              eng_kernels),
            "outputs_equal_bit_for_bit": True,
            "launches_per_forward": eng_gains,
            "child_imported": loaded["importer_modules"],
            "device": smi}


def _trace_attribution(trace_dir: str, kernel: str) -> dict:
    """From the chrome trace `profile` wrote: each `QLinearConv.<node>`
    range, the device time of the `kernel` launches made under it (the
    launch's runtime call within the range on its thread, matched to the
    kernel by correlation id)."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("QLinearConv.")
              and e.get("cat") == "user_annotation"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel in e.get("name", "")]
    held, under = [], set()
    for k in kernels:
        launch = launches.get(k["args"].get("correlation"))
        r = None if launch is None else next(
            (i for i, r in enumerate(ranges) if r["tid"] == launch["tid"]
             and r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]), None)
        if r is not None:
            held.append(k["dur"])
            under.add(r)
    return {"ranges": len(ranges), "kernels": len(kernels),
            "kernels_under_ranges": len(held),
            "ranges_holding_the_kernel": len(under),
            "kernel_ms_under_ranges": sum(held) / 1e3,
            "kernel_ms": sum(k["dur"] for k in kernels) / 1e3}


def phase_export(smi: str) -> None:
    """The four Engines of EXPORT through export_engine and a fresh
    process each (phase_export_model), then `profile` once on SqueezeNet
    INT8 (the CLI, as a user runs it: a process of its own; a trace taken
    after this process's many profiler sessions can lack a kernel): its
    trace must hold a QLinearConv range per node and forward, with every
    int8 conv kernel's device time under one."""
    import tempfile

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    for model in EXPORT:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(HERE, "build")) as d:
            emit(phase_export_model(model, d, smi))
        torch.cuda.empty_cache()
    steps = 2
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        _export_files("squeezenet1.0 int8 b256", d)
        t0 = time.perf_counter()
        rc, out, err = _finish(_cli(
            "profile", "--model", os.path.join(d, "model.onnx"),
            "--quantize", "int8", "--batch", str(BATCH), "--steps",
            str(steps), "--trace-dir", os.path.join(d, "trace")))
        require(rc == 0, f"profile exited {rc}: {err[-3000:]}")
        body = json.loads(out.strip().splitlines()[-1])
        require(body["steps"] == steps and "forwards" in body,
                f"profile's JSON {body}")
        seen = _trace_attribution(os.path.join(d, "trace"),
                                  "qconv_int8_requant")
    require(seen["ranges"] == seen["kernels"] == 26 * steps
            and seen["kernels_under_ranges"] == 26 * steps
            and seen["ranges_holding_the_kernel"] == 26 * steps
            and seen["kernel_ms_under_ranges"] > 0,
            f"profile: every int8 conv launch under its QLinearConv range "
            f"{seen}")
    emit({"phase": "export_profile", "model": "squeezenet1.0 int8 b256",
          "steps": steps, "seconds": time.perf_counter() - t0, **seen})
    emit({"phase": "export_seconds",
          "seconds": time.perf_counter() - t_phase})


# --------------------------------------------------------------------------
# Scan-over-layers decode: GPT-2 124M and Llama, scan form vs per-layer
# --------------------------------------------------------------------------
SCAN_LLAMA_LAYERS = 1      # of LlamaConfig()'s 32 (phase 18's depth)
SCAN_STEP_REPS = 20        # replays per step timing


def _replayed_step(gen) -> dict:
    """The decode Engine's captured step graph (the main path's one input
    signature), replayed back to back: wall and device-busy ms per step,
    the device ops per replay (device_busy)."""
    graphs = list(gen.decode._graphs.values())
    require(len(graphs) == 1, f"one captured decode signature: "
                              f"{len(graphs)}")
    with torch.no_grad():
        return device_busy(graphs[0].replay, SCAN_STEP_REPS)


def _scan_form(cfg, family: str, per_step: int, prompts, label: str,
               smi: str) -> dict:
    """The scan-over-layers decode (INT4 planar weights, INT8 KV, attention
    unfused as JAX requires) against the per-layer form with the same
    arguments, on the card: counts set to 0 just before each form's main
    path (gen.generate, NEW greedy tokens) and read just after; `per_step`
    int4 launches per prefill and per step in both; tokens equal; the
    prefill and CPU_STEPS teacher-forced steps of the two forms equal bit
    for bit (logits and every layer's cache); the scan form's logits
    within 1e-2 x max|logit| of the plain versions on the CPU; replayed
    step ms, tokens/s, copy kernels per step for both; then the scan form
    with device_loop = SERVE_K. Returns the line's fields."""
    steps = NEW - 1
    out = {"model": label, "batch": DEC_BATCH, "prompt": PROMPT,
           "max_len": MAX_LEN, "new_tokens": NEW, "card": smi}
    gens, toks, counts = {}, {}, {}
    for form, kw in (("per_layer", {}), ("scan", {"scan_layers": True})):
        t0 = time.perf_counter()
        gens[form] = gen = _generator(cfg, family=family, kv_dtype="int8",
                                      int4_weights=True, **kw)
        out[f"{form}_build_s"] = time.perf_counter() - t0
        n4 = (sum(reps for _, reps in matmul_nbits_nodes(
            gen.prefill.graph)), sum(reps for _, reps in matmul_nbits_nodes(
                gen.decode.graph)))
        require(n4 == (per_step, per_step), f"{label} {form}: {per_step} "
                f"MatMulNBits per prefill and per step: {n4}")
        reset_counts()
        t0 = time.perf_counter()
        toks[form], _ = gen.generate(prompts, NEW)
        counts[form] = read_counts()
        out[f"{form}_main_path_s"] = time.perf_counter() - t0
        c = counts[form]
        require(c["qmatmul_int4_planar"] == per_step * (1 + steps)
                and sum(c.values()) == c["qmatmul_int4_planar"],
                f"{label} {form}: {per_step} int4 launches per prefill and "
                f"per step and no other kernel: {c}")
        out[f"{form}_int4_schedules"] = _int4_schedules(
            gen, "qmatmul_int4_planar", steps)
    scan, per = gens["scan"], gens["per_layer"]
    require(np.array_equal(toks["scan"], toks["per_layer"]),
            f"{label}: the scan form's {DEC_BATCH} x {NEW} greedy tokens "
            f"equal the per-layer form's")
    require(out["scan_int4_schedules"] == out["per_layer_int4_schedules"],
            f"{label}: the same int4 schedules in both forms")

    # the two forms on the same inputs: bit for bit
    ls, cs = scan.start(prompts)
    lp, cp = per.start(prompts)
    diffs = [float((ls - lp).abs().max())]
    cache_equal = True
    for t in range(CPU_STEPS):
        tok = torch.from_numpy(toks["scan"][:, t]).cuda()
        ls, cs = scan.step(cs, tok, PROMPT + t)
        lp, cp = per.step(cp, tok, PROMPT + t)
        diffs.append(float((ls - lp).abs().max()))
        for i in range(cfg.n_layer):
            for kind in ("key", "value"):
                cache_equal &= bool(torch.equal(
                    cs[f"past_{kind}"][i], cp[f"past_{kind}_{i}"]))
    require(max(diffs) == 0.0 and cache_equal,
            f"{label}: the scan form's logits and cache equal the "
            f"per-layer form's bit for bit: {diffs}, cache {cache_equal}")
    t0 = time.perf_counter()
    errs, agree = _plain_rerun(scan, prompts, toks["scan"])
    out.update(launches={f: counts[f] for f in counts},
               int4_per_step=per_step,
               tokens_equal=True, logits_max_abs_diff_vs_per_layer=diffs,
               cache_equal_per_layer=True,
               card_vs_plain_rel_err=errs, plain_greedy_agreement=agree,
               plain_rerun_s=time.perf_counter() - t0,
               tokens_row0=toks["scan"][0, :16].tolist())

    # replayed steps, tokens/s, copies per step
    for form, gen in gens.items():
        out[f"{form}_step_replay"] = _replayed_step(gen)
        out[f"{form}_tokens_per_s"] = _decode_tokens_per_s(gen, prompts)
        prof = phase_decode_profile(
            gen, prompts, reps=3, engine=f"{label} decode step ({form}, "
                                          f"int4, int8 KV, unfused)")
        out[f"{form}_copy_kernels_per_step"] = prof["copy_kernels_per_step"]
        out[f"{form}_concat_kernels_per_step"] = prof[
            "concat_kernels_per_step"]
        out[f"{form}_device_ops_per_step"] = prof["device_ops_per_step"]
    out["scan_added_copy_kernels_per_step"] = sum(
        out[f"scan_{k}_kernels_per_step"] - out[f"per_layer_{k}_kernels_per_"
                                                f"step"]
        for k in ("copy", "concat"))
    out["scan_vs_per_layer_replayed_step"] = (
        out["scan_step_replay"]["busy_ms"]
        / out["per_layer_step_replay"]["busy_ms"])

    # the scan form with device_loop = K
    K = SERVE_K
    blocks = -(-steps // K)
    scan.device_loop = K
    try:
        first = scan.generate(prompts, NEW)[0]       # eager block, capture
        block = scan._blocks[next(iter(scan._blocks))]
        reset_counts()
        again = scan.generate(prompts, NEW)[0]       # replays
        counts_dl = read_counts()
        tps_dl = _decode_tokens_per_s(scan, prompts)
        with torch.no_grad():
            block_t = device_busy(block["replay"], 5)
    finally:
        scan.device_loop = 0
    require(np.array_equal(first, toks["scan"])
            and np.array_equal(again, toks["scan"]),
            f"{label}: the scan form's device_loop tokens equal its host "
            f"loop's")
    require(counts_dl["qmatmul_int4_planar"] == per_step * (1 + blocks * K),
            f"{label}: {per_step} int4 launches per step over {blocks} "
            f"replayed blocks: {counts_dl}")
    out["scan_device_loop"] = {
        "K": K, "blocks": blocks, "greedy_equals_host": True,
        "launches": counts_dl, "tokens_per_s": tps_dl,
        "block_replay": block_t, "step_wall_ms": block_t["wall_ms"] / K,
        "step_busy_ms": block_t["busy_ms"] / K}
    out["_gens"] = gens
    return out


def phase_scan_decode(smi: str) -> dict:
    """The scan-over-layers decode graphs on the card: GPT-2 124M (all 12
    layers: its Scan iterates) and Llama at LlamaConfig()'s widths with
    SCAN_LLAMA_LAYERS of its 32 layers, each through _scan_form;
    one line per model. Returns the qmatmul_int4_planar numbers of one
    GPT-2 scan-form step (its kernel lines, with the Scan body's weights
    as the slices of the stacked weights each iteration gets) for the
    kernels line."""
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
    from onnx_rusty_inference_engine_tpu_torch.models.llama import (
        LlamaConfig)

    gcfg = GPT2Config()
    g = _scan_form(gcfg, "gpt2", 4 * gcfg.n_layer + 1,
                   _decode_prompts(gcfg), "gpt2 124M (SMALL, seed 0)", smi)
    gens = g.pop("_gens")
    row = int4_kernel_row(
        gens["scan"], "qmatmul_int4_planar",
        g["launches"]["scan"]["qmatmul_int4_planar"], smi,
        per="one GPT-2 124M scan-form decode step at batch 8: the sum over "
            "its 49 launches (the Scan body's 4 per layer, on layer 0's "
            "slices of the stacked weights, + the lm_head)")
    emit({"phase": "scan_decode", **g})
    del gens
    torch.cuda.empty_cache()

    L = SCAN_LLAMA_LAYERS
    lcfg = LlamaConfig(n_layer=L)
    llama = _scan_form(
        lcfg, "llama", 7 * L + 1, _decode_prompts(lcfg),
        f"llama-7b widths (LlamaConfig(): dim 4096, 32 heads / 8 KV heads "
        f"of 128, FFN 16384, vocab 32000), {L} of 32 layers, seed 0", smi)
    llama.pop("_gens")
    emit({"phase": "scan_decode", **llama})
    torch.cuda.empty_cache()
    return {k: row[k] for k in ("launches", "max_abs_err", "max_rel_err",
                                "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "per")}


# --------------------------------------------------------------------------
# ONNX control flow and recurrence: If / Loop / Scan, sequences, RNNs
# --------------------------------------------------------------------------
RNN_T, RNN_B, RNN_I, RNN_H = 128, 64, 512, 512  # a speech / series encoder


def _sub(b_name: str, inputs, outputs, build) -> object:
    """An attribute subgraph with untyped declared inputs and outputs (they
    bind by position): `build(bb)` adds its nodes and initializers."""
    from onnx_rusty_inference_engine_tpu_torch import onnx_io
    from onnx_rusty_inference_engine_tpu_torch.models._builder import (
        GraphBuilder)

    bb = GraphBuilder(b_name, opset=17)
    bb.g.inputs = [onnx_io.ValueInfo(name=n) for n in inputs]
    bb.g.outputs = [onnx_io.ValueInfo(name=n) for n in outputs]
    build(bb)
    return bb.g


def control_flow_graphs(seed: int = 0) -> dict:
    """name -> (Graph, [(feed label, feed)], bound): the control-flow and
    recurrence graphs the control_flow phase runs, weights and inputs from
    `seed`. bound "max": 1e-5 x max|out|; "rnn": rtol 1e-4, atol 1e-5."""
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model
    from onnx_rusty_inference_engine_tpu_torch.models._builder import (
        GraphBuilder)

    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    graphs = {}

    # If on a predicate computed at run time, [4096, 1024] branches
    b = GraphBuilder("if_runtime_predicate", opset=17)
    b.input("x", [4096, 1024])
    b.init("wb", f32(1024, 1024, scale=1024 ** -0.5))
    b.init("zero", np.float32(0.0))
    b.node("ReduceMax", ["x"], ["mx"], keepdims=0)
    b.node("Greater", ["mx", "zero"], ["p"])

    def then_b(bb):
        bb.init("wa", f32(1024, 1024, scale=1024 ** -0.5))
        bb.node("MatMul", ["x", "wa"], ["o"])

    def else_b(bb):
        bb.node("MatMul", ["x", "wb"], ["m"])
        bb.node("Tanh", ["m"], ["o"])

    b.node("If", ["p"], ["y"], then_branch=_sub("then", [], ["o"], then_b),
           else_branch=_sub("else", [], ["o"], else_b))
    b.output("y", [4096, 1024])
    x = np.abs(f32(4096, 1024))
    graphs["if_runtime_predicate"] = (
        import_model(b.model()), [("then", {"x": x}), ("else", {"x": -x})],
        "max")

    # Loop of 32 trips over a [1024, 1024] state that exits after 20; the
    # weight is orthogonal, so a trip neither grows nor shrinks the
    # state's rounding differences (tanh only contracts them)
    b = GraphBuilder("loop_early_exit", opset=17)
    b.input("s0", [1024, 1024])
    b.input("c0", [])
    b.init("M", np.array(32, np.int64))
    b.init("w", np.linalg.qr(f32(1024, 1024))[0].astype(np.float32))
    b.init("cond", np.array(True))

    def loop_b(bb):
        bb.init("one", np.float32(1.0))
        bb.init("stop", np.float32(20.0))
        bb.node("MatMul", ["s_in", "w"], ["sw"])
        bb.node("Tanh", ["sw"], ["s_out"])
        bb.node("Add", ["c_in", "one"], ["c_out"])
        bb.node("Less", ["c_out", "stop"], ["cond_out"])

    b.node("Loop", ["M", "cond", "s0", "c0"], ["s", "c"],
           body=_sub("loop_body", ["i", "cond_in", "s_in", "c_in"],
                     ["cond_out", "s_out", "c_out"], loop_b))
    b.output("s", [1024, 1024])
    b.output("c", [])
    graphs["loop_early_exit"] = (
        import_model(b.model()),
        [("from_0", {"s0": f32(1024, 1024), "c0": np.float32(0.0)})], "max")

    # Loop with sequence state: a tensor state and a sequence it appends to
    b = GraphBuilder("loop_sequence_state", opset=17)
    b.input("h0", [256, 1024])
    b.init("M", np.array(8, np.int64))
    b.init("w", f32(1024, 1024, scale=1024 ** -0.5))
    b.node("SequenceEmpty", [], ["seq0"])

    def seq_b(bb):
        bb.node("Identity", ["cond_in"], ["cond_out"])
        bb.node("MatMul", ["h_in", "w"], ["hw"])
        bb.node("Tanh", ["hw"], ["h_out"])
        bb.node("SequenceInsert", ["seq_in", "h_out"], ["seq_out"])

    b.node("Loop", ["M", "", "h0", "seq0"], ["h", "seq"],
           body=_sub("seq_body", ["i", "cond_in", "h_in", "seq_in"],
                     ["cond_out", "h_out", "seq_out"], seq_b))
    b.node("ConcatFromSequence", ["seq"], ["hs"], axis=0, new_axis=1)
    b.node("SequenceLength", ["seq"], ["n"])
    b.output("hs", [256, 8, 1024])
    b.output("n", [], dtype=np.int64)
    graphs["loop_sequence_state"] = (
        import_model(b.model()), [("h0", {"h0": f32(256, 1024)})], "max")

    # reverse Scan over two scan inputs (the second on its axis 1)
    T, B, D = 64, 256, 512
    b = GraphBuilder("scan_reverse_two_inputs", opset=17)
    b.input("h0", [B, D])
    b.input("xs", [T, B, D])
    b.input("zs", [B, T, D])
    b.init("w", f32(D, D, scale=D ** -0.5))

    def scan_b(bb):
        bb.node("MatMul", ["h", "w"], ["hw"])
        bb.node("Add", ["hw", "x_t"], ["a"])
        bb.node("Add", ["a", "z_t"], ["a2"])
        bb.node("Tanh", ["a2"], ["h2"])
        bb.node("Sub", ["h2", "x_t"], ["y"])

    b.node("Scan", ["h0", "xs", "zs"], ["hT", "ys"],
           body=_sub("scan_body", ["h", "x_t", "z_t"], ["h2", "y"], scan_b),
           num_scan_inputs=2,
           scan_input_axes=[0, 1], scan_input_directions=[1, 1],
           scan_output_axes=[1], scan_output_directions=[1])
    b.output("hT", [B, D])
    b.output("ys", [B, T, D])
    graphs["scan_reverse_two_inputs"] = (
        import_model(b.model()),
        [("h0", {"h0": f32(B, D), "xs": f32(T, B, D), "zs": f32(B, T, D)})],
        "max")

    # LSTM (bidirectional), GRU and RNN at a speech encoder's size
    T, B, I, H = RNN_T, RNN_B, RNN_I, RNN_H
    for op, gates, dirs, outs, attrs in (
            ("LSTM", 4, 2, ["y", "y_h", "y_c"],
             {"direction": "bidirectional"}),
            ("GRU", 3, 1, ["y", "y_h"], {}),
            ("RNN", 1, 1, ["y", "y_h"], {})):
        b = GraphBuilder(op.lower(), opset=17)
        b.input("x", [T, B, I])
        b.init("W", f32(dirs, gates * H, I, scale=I ** -0.5))
        b.init("R", f32(dirs, gates * H, H, scale=H ** -0.5))
        b.init("B", f32(dirs, 2 * gates * H, scale=0.1))
        b.node(op, ["x", "W", "R", "B"], outs, hidden_size=H, **attrs)
        for o in outs:
            b.output(o)
        graphs[op.lower()] = (import_model(b.model()),
                              [("x", {"x": f32(T, B, I)})], "rnn")
    return graphs


def _cf_check(got: dict, want: dict, bound: str) -> float:
    """Max |card - CPU| / max|CPU| over the outputs, held to the bound."""
    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        require(tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype,
                f"{k}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
                f"{w.dtype}")
        if not w.dtype.is_floating_point:
            require(torch.equal(g, w), f"{k}: integers equal")
            continue
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        worst = max(worst, err / top if top else err)
        if bound == "rnn":
            require(torch.allclose(g, w, rtol=1e-4, atol=1e-5),
                    f"{k}: rtol 1e-4, atol 1e-5 of the CPU's ({err})")
        else:
            require(err <= 1e-5 * top, f"{k}: {err} > 1e-5 x {top}")
    return worst


def phase_control_flow(smi: str) -> None:
    """Each control_flow_graphs() graph on the card through an Engine: the
    first call (eager, then captured), a replay of every feed and an eager
    forward of every feed, each held against the port's CPU run of the
    same graph and feed (TF32 off); an If's two predicate values share one
    captured graph, which must pick by the predicate on the device. Per
    graph: the replayed ms (device busy and wall), the device ops per
    replay, the eager wall ms; one line each."""
    from onnx_rusty_inference_engine_tpu_torch.engine import Engine
    from onnx_rusty_inference_engine_tpu_torch.weights import (
        as_device_tensor)

    for name, (graph, feeds, bnd) in control_flow_graphs().items():
        t0 = time.perf_counter()
        cpu = Engine(graph, device="cpu")
        want = {label: cpu(feed) for label, feed in feeds}
        cpu_s = time.perf_counter() - t0
        eng = Engine(graph)
        errs = {}
        with torch.no_grad():
            label0, feed0 = feeds[0]
            errs[f"first_call_{label0}"] = _cf_check(eng(feed0),
                                                     want[label0], bnd)
            for label, feed in feeds:
                dev = {k: as_device_tensor(v, eng.device)
                       for k, v in feed.items()}
                errs[f"replay_{label}"] = _cf_check(eng(feed), want[label],
                                                    bnd)
                errs[f"eager_{label}"] = _cf_check(eng.forward(dev),
                                                   want[label], bnd)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.forward(dev)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3
            require(len(eng._graphs) == 1, f"{name}: one captured graph")
            replay = device_busy(next(iter(eng._graphs.values())).replay, 5)
        emit({"phase": "control_flow", "graph": name,
              "nodes": [n.op_type for n in graph.nodes],
              "inputs": {k: list(np.shape(v)) for k, v in feeds[0][1].items()},
              "feeds": [label for label, _ in feeds],
              "bound": ("1e-5 x max|out|" if bnd == "max"
                        else "rtol 1e-4, atol 1e-5"),
              "max_rel_err_vs_cpu": errs, "replayed_ms": replay["busy_ms"],
              "replayed_wall_ms": replay["wall_ms"],
              "launches_per_replay": replay["device_ops"],
              "eager_wall_ms": eager_ms, "cpu_s": cpu_s, "card": smi})
        del eng, cpu
        torch.cuda.empty_cache()


# the op library's families at full width
UNET_BATCH, UNET_SIZE = 32, 256
UNET_QCONVS = 11     # QLinearConvs of UNetConfig()'s INT8 graph
AUDIO_BATCH, AUDIO_SAMPLES = 16, 480000   # 30 s clips at 16 kHz
FAMILY_CPU = 2       # images / clips re-run on the CPU
FAMILY_ITERS = 3     # replayed forwards timed per Engine


def _oplib():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_port_oplib

    return torch_port_oplib


def _graph_replay_ms(eng, iters: int) -> float:
    """Device ms per replay of the Engine's one captured graph."""
    require(len(eng._graphs) == 1, "one captured graph")
    return cuda_ms(next(iter(eng._graphs.values())).replay, iters)


def output_steps(qgraph, name: str, got: np.ndarray,
                 ref: np.ndarray) -> int:
    """The largest difference of two runs' output `name` of an INT8 graph,
    in steps of the scale of the DequantizeLinear that makes it."""
    (node,) = [n for n in qgraph.nodes if name in n.outputs]
    require(node.op_type == "DequantizeLinear",
            f"{name} comes from a DequantizeLinear, not {node.op_type}")
    scale = float(np.asarray(qgraph.constants[node.inputs[1]]))
    return int(np.rint(np.abs(got - ref) / scale).max())


@contextlib.contextmanager
def _tf32():
    """TF32 on for cuBLAS and cuDNN inside the block, as a caller may set
    it; the port's emitters switch it off around their convs and matrix
    products (utils/fp32.py)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=True), torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


# |card - CPU| / max|CPU| of the float families (UNet fp32, the audio
# encoder): between the sound readings (~1e-6) and what TF32 does to one
# product at their widths (_tf32_rel_err)
FAMILY_REL_TOL = 1e-5


def _tf32_rel_err(fn) -> float:
    """max|fn() with TF32 on - fn() with it off| / max|fn() off|: what
    TF32 alone does to a plain library product."""
    with torch.no_grad():
        off = fn()
        with _tf32():
            on = fn()
    return float((on - off).abs().max() / off.abs().max())


def _emitter_module(op: str, domain: str) -> str:
    """The module of the op's emitter, or "static" for the ops that have
    none: run_nodes makes them static values (registry.STATIC_OPS)."""
    from onnx_rusty_inference_engine_tpu_torch.ops.registry import (
        STATIC_OPS, UnsupportedOpError, get_emitter)

    try:
        return get_emitter(op, domain).__module__.rsplit(".", 1)[-1]
    except UnsupportedOpError:
        require(op in STATIC_OPS, f"{op} has no emitter")
        return "static"


def _wide_attention_cases(oplib) -> list:
    """The ORT attention ops at BERT-base widths (B 32, T 128, 12 heads of
    64) and GroupQueryAttention at LlamaConfig()'s heads (32 on 8 KV
    heads of 128; B 4, S 256), inputs from seed 0."""
    r = np.random.default_rng(0)
    B, T, D, H = 32, 128, 768, 12

    def f(*shape, scale=1.0):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    lens = r.integers(32, T + 1, B).astype(np.int32)
    keymask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    tol = (1e-4, 1e-4)
    ms = "com.microsoft"
    x = f(B, T, D)
    cases = [
        oplib.case("Attention_bert", "Attention", {"x": x},
                   {"w": f(D, 3 * D, scale=D ** -0.5), "b": f(3 * D),
                    "m": lens}, domain=ms, tol=tol, num_heads=H),
        oplib.case("MultiHeadAttention_bert", "MultiHeadAttention",
                   {"q": x, "k": f(B, T, D), "v": f(B, T, D)},
                   {"kpm": keymask}, ins=["q", "k", "v", "", "kpm"],
                   domain=ms, tol=tol, num_heads=H),
        oplib.case("SkipLayerNormalization_bert", "SkipLayerNormalization",
                   {"x": x, "skip": f(B, T, D)},
                   {"g": f(D), "beta": f(D), "bias": f(D)}, domain=ms,
                   tol=tol, epsilon=1e-12),
        oplib.case("Attention_core_bert", "Attention",
                   {"q": f(B, H, T, 64), "k": f(B, H, T, 64),
                    "v": f(B, H, T, 64)}, opset=23, tol=tol, is_causal=1),
    ]
    Bq, S, Hq, Hkv, hd = 4, 256, 32, 8, 128
    ang = r.uniform(0, 3, (S, hd // 2)).astype(np.float32)
    cases.append(oplib.case(
        "GroupQueryAttention_llama", "GroupQueryAttention",
        {"q": f(Bq, S, Hq * hd), "k": f(Bq, S, Hkv * hd),
         "v": f(Bq, S, Hkv * hd)},
        {"sl": (r.integers(S // 2, S, Bq)).astype(np.int32),
         "tot": np.array(S, np.int32), "cos": np.cos(ang),
         "sin": np.sin(ang)},
        ins=["q", "k", "v", "", "", "sl", "tot", "cos", "sin"], domain=ms,
        tol=tol, num_heads=Hq, kv_num_heads=Hkv, do_rotary=1))
    return cases


def phase_op_library(smi: str) -> dict:
    """The op library this slice took over from the JAX package: every
    case of tests/torch_port_oplib.py (one or more per op) through an
    Engine on the card, eager and replayed, against the port's CPU run of
    the same graph and inputs (exact for integer, boolean and index
    outputs, else the CPU tests' tolerance); one line per emitter module
    with its worst errors. The ORT attention ops at BERT-base widths and
    GroupQueryAttention at Llama's heads, each against the CPU and timed
    replayed. Then UNet (UNetConfig(), 256x256, b32) fp32 and INT8 and the
    audio encoder (AudioEncoderConfig(), 30 s clips, b16), random weights
    from seed 0, each forward a captured graph: the first FAMILY_CPU
    images / clips against the port's CPU run; counts set to 0 just before
    the INT8 UNet's first call and read after its forwards: exactly
    UNET_QCONVS qconv_int8_requant launches a forward and no other kernel;
    INT8 UNet's per-pixel argmax agreement with fp32 > 0.95 (the JAX
    test's bound); images/s and clips/s from replays; device ms by op
    type. Returns the INT8 UNet's qconv_int8_requant counts."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models.audio import (
        AudioEncoderConfig, build_audio_encoder)
    from onnx_rusty_inference_engine_tpu_torch.models.unet import (
        UNetConfig, build_unet)

    oplib = _oplib()
    t_phase = time.perf_counter()
    by_module = {}
    for c in oplib.ALL_CASES:
        mod = _emitter_module(c.op, c.domain)
        errs, eng = oplib.card_vs_cpu(c)
        row = by_module.setdefault(mod, {"cases": 0, "ops": set(),
                                         "eager": 0.0, "replayed": 0.0})
        row["cases"] += 1
        row["ops"].add(c.op)
        for k in ("eager", "replayed"):
            row[k] = max(row[k], errs[k])
        del eng
    for mod, row in sorted(by_module.items()):
        emit({"phase": "op_library", "module": mod, "cases": row["cases"],
              "ops": len(row["ops"]),
              "worst_abs_err_vs_cpu": {"eager": row["eager"],
                                       "replayed": row["replayed"]},
              "bound": "exact for integer, boolean and index outputs, "
                       "else the case's CPU-test tolerance"})
    cases_s = time.perf_counter() - t_phase

    for c in _wide_attention_cases(oplib):
        t0 = time.perf_counter()
        errs, eng = oplib.card_vs_cpu(c)
        emit({"phase": "op_library", "wide": c.id, "op": c.op,
              "inputs": {k: list(v.shape) for k, v in c.feeds.items()},
              "worst_abs_err_vs_cpu": errs, "bound": "rtol 1e-4, atol 1e-4",
              "replayed_ms": _graph_replay_ms(eng, 20),
              "seconds": time.perf_counter() - t0, "card": smi})
        del eng
    torch.cuda.empty_cache()

    # UNet fp32 and INT8
    t0 = time.perf_counter()
    cfg = UNetConfig()
    graph = P.import_model(build_unet(cfg, batch=UNET_BATCH, size=UNET_SIZE))
    small = P.import_model(build_unet(cfg, batch=FAMILY_CPU, size=UNET_SIZE))
    x = np.random.default_rng(0).standard_normal(
        (UNET_BATCH, 3, UNET_SIZE, UNET_SIZE)).astype(np.float32)
    dev = {"image": torch.as_tensor(x, device="cuda")}
    eng = P.Engine(graph)
    y32 = eng(dev)["mask_logits"]
    y32r = eng(dev)["mask_logits"]
    fp32_ms = _graph_replay_ms(eng, FAMILY_ITERS)
    want = P.Engine(small, device="cpu").run(
        {"image": x[:FAMILY_CPU]}).outputs["mask_logits"]
    ranges = P.calibrate(graph, [{"image": x[:8]}])
    qgraph = P.quantize_graph(graph, ranges=ranges)
    qsmall = P.quantize_graph(small, ranges=ranges)
    ops = {}
    for n in qgraph.nodes:
        ops[n.op_type] = ops.get(n.op_type, 0) + 1
    require(ops.get("QLinearConv") == UNET_QCONVS
            and ops.get("ConvTranspose") == cfg.depth,
            f"unet int8 nodes: {ops}")
    eng8 = P.Engine(qgraph)
    reset_counts()
    y8 = eng8(dev)["mask_logits"]
    y8r = eng8(dev)["mask_logits"]
    int8_ms = _graph_replay_ms(eng8, FAMILY_ITERS)
    counts = read_counts()
    forwards = 2 + FAMILY_ITERS + 1   # _graph_replay_ms's cuda_ms warms once
    require({k: v for k, v in counts.items() if v}
            == {"qconv_int8_requant": UNET_QCONVS * forwards},
            f"unet int8: {UNET_QCONVS} qconv_int8_requant a forward over "
            f"{forwards} forwards: {counts}")
    want8 = P.Engine(qsmall, device="cpu").run(
        {"image": x[:FAMILY_CPU]}).outputs["mask_logits"]
    errs = {}
    for label, got in (("fp32_eager", y32), ("fp32_replayed", y32r)):
        g = got[:FAMILY_CPU].cpu().numpy()
        errs[label] = float(np.abs(g - want).max() / np.abs(want).max())
        require(errs[label] <= FAMILY_REL_TOL, f"unet {label}: "
                f"{errs[label]} > {FAMILY_REL_TOL} x max|ref|")
    steps = {}
    for label, got in (("int8_eager", y8), ("int8_replayed", y8r)):
        steps[label] = output_steps(qgraph, "mask_logits",
                                    got[:FAMILY_CPU].cpu().numpy(), want8)
        require(steps[label] <= 1, f"unet {label}: {steps[label]} output "
                f"steps from the CPU's INT8 run (bound 1)")
    with _tf32():
        g = eng.forward(dev)["mask_logits"][:FAMILY_CPU].cpu().numpy()
    errs["fp32_eager_caller_tf32"] = float(
        np.abs(g - want).max() / np.abs(want).max())
    require(errs["fp32_eager_caller_tf32"] <= FAMILY_REL_TOL,
            f"unet fp32 under the caller's TF32 flags: "
            f"{errs['fp32_eager_caller_tf32']} > {FAMILY_REL_TOL} x "
            f"max|ref|")
    gen = torch.Generator("cuda").manual_seed(0)
    xc = torch.randn(UNET_BATCH, cfg.base, UNET_SIZE, UNET_SIZE,
                     device="cuda", generator=gen)
    wc = torch.randn(cfg.base, cfg.base, 3, 3, device="cuda",
                     generator=gen) / 12
    tf32_err = _tf32_rel_err(lambda: torch.nn.functional.conv2d(
        xc, wc, padding=1))
    del xc
    agree = float((y8.argmax(1) == y32.argmax(1)).float().mean())
    require(agree > 0.95, f"unet int8 vs fp32 argmax agreement {agree}")
    ms32, _ = _ms_by_op(eng, dev, 2)
    ms8, k8 = _ms_by_op(eng8, dev, 2)
    unet_convs = _unet_conv_row(qgraph, eng8, x, forwards)
    emit({"phase": "op_library", "model": "unet", "config": vars(cfg),
          "size": UNET_SIZE, "batch": UNET_BATCH,
          "fp32_images_per_s": UNET_BATCH / fp32_ms * 1e3,
          "int8_images_per_s": UNET_BATCH / int8_ms * 1e3,
          "fp32_replayed_ms": fp32_ms, "int8_replayed_ms": int8_ms,
          "max_rel_err_vs_cpu": errs,
          "int8_output_steps_vs_cpu": steps,
          "tf32_conv_rel_err": tf32_err,
          "tf32_conv": f"F.conv2d [{UNET_BATCH}, {cfg.base}, {UNET_SIZE}, "
                       f"{UNET_SIZE}] x [{cfg.base}, {cfg.base}, 3, 3], "
                       f"TF32 on against off",
          "bound": f"fp32 {FAMILY_REL_TOL} x max|ref|; INT8 at most 1 "
                   f"step of the output's scale from the CPU's INT8",
          "int8_vs_fp32_argmax_agreement": agree, "int8_nodes": ops,
          "launches": {k: v for k, v in counts.items() if v},
          "int8_forwards": forwards, "fp32_ms_by_op": ms32,
          "int8_ms_by_op": ms8, "int8_kernel_ms": k8,
          "seconds": time.perf_counter() - t0, "card": smi})
    del eng, eng8, y32, y32r, y8, y8r
    torch.cuda.empty_cache()

    # the audio encoder on 30 s clips
    t0 = time.perf_counter()
    acfg = AudioEncoderConfig()
    graph = P.import_model(build_audio_encoder(
        acfg, batch=AUDIO_BATCH, n_samples=AUDIO_SAMPLES))
    small = P.import_model(build_audio_encoder(
        acfg, batch=FAMILY_CPU, n_samples=AUDIO_SAMPLES))
    wav = (np.random.default_rng(0).standard_normal(
        (AUDIO_BATCH, AUDIO_SAMPLES)) * 0.1).astype(np.float32)
    dev = {"audio": torch.as_tensor(wav, device="cuda")}
    eng = P.Engine(graph)
    ya = eng(dev)["logits"]
    yar = eng(dev)["logits"]
    audio_ms = _graph_replay_ms(eng, FAMILY_ITERS)
    want = P.Engine(small, device="cpu").run(
        {"audio": wav[:FAMILY_CPU]}).outputs["logits"]
    errs = {}
    for label, got in (("eager", ya), ("replayed", yar)):
        g = got[:FAMILY_CPU].cpu().numpy()
        errs[label] = float(np.abs(g - want).max() / np.abs(want).max())
        require(errs[label] <= FAMILY_REL_TOL, f"audio {label}: "
                f"{errs[label]} > {FAMILY_REL_TOL} x max|ref|")
    require(tuple(ya.shape) == (AUDIO_BATCH, acfg.num_classes)
            and bool(torch.isfinite(ya).all()), "audio logits")
    with _tf32():
        g = eng.forward(dev)["logits"][:FAMILY_CPU].cpu().numpy()
    errs["eager_caller_tf32"] = float(
        np.abs(g - want).max() / np.abs(want).max())
    require(errs["eager_caller_tf32"] <= FAMILY_REL_TOL,
            f"audio under the caller's TF32 flags: "
            f"{errs['eager_caller_tf32']} > {FAMILY_REL_TOL} x max|ref|")
    n_frames = (AUDIO_SAMPLES - acfg.n_fft) // acfg.hop + 1
    gen = torch.Generator("cuda").manual_seed(0)
    xa = torch.randn(AUDIO_BATCH * (n_frames // 2), acfg.d_model,
                     device="cuda", generator=gen)
    wa = torch.randn(acfg.d_model, 4 * acfg.d_model, device="cuda",
                     generator=gen) * acfg.d_model ** -0.5
    tf32_err = _tf32_rel_err(lambda: xa @ wa)
    del xa
    msa, _ = _ms_by_op(eng, dev, 2)
    emit({"phase": "op_library", "model": "audio_encoder",
          "config": vars(acfg), "samples": AUDIO_SAMPLES,
          "frames": n_frames, "positions": n_frames // 2,
          "batch": AUDIO_BATCH, "clips_per_s": AUDIO_BATCH / audio_ms * 1e3,
          "replayed_ms": audio_ms, "max_rel_err_vs_cpu": errs,
          "tf32_matmul_rel_err": tf32_err,
          "tf32_matmul": f"[{AUDIO_BATCH * (n_frames // 2)}, "
                         f"{acfg.d_model}] @ [{acfg.d_model}, "
                         f"{4 * acfg.d_model}], TF32 on against off",
          "bound": f"{FAMILY_REL_TOL} x max|ref|", "ms_by_op": msa,
          "seconds": time.perf_counter() - t0, "card": smi})
    del eng, ya, yar
    torch.cuda.empty_cache()
    emit({"phase": "op_library", "seconds": time.perf_counter() - t_phase,
          "cases_s": cases_s})
    return {"launches": counts["qconv_int8_requant"],
            "per_forward": UNET_QCONVS, "forwards": forwards, **unet_convs}


def _unet_conv_row(qgraph, eng8, x: np.ndarray, forwards: int) -> dict:
    """The INT8 UNet's 11 QLinearConvs at their own shapes (b32, 256x256):
    a kernel line per distinct shape, on the card's own inputs, equal to
    the plain version, with the kernel, plain and bound times
    (`_vision_conv_lines`); and the library call of the one 1x1 conv, the
    2-class head (models/unet.py:75): torch._int_mm on its input as
    [B * H * W, C] with its 2 output channels padded to 8, the least
    _int_mm takes. The 3x3 convs have no library call: torch._int_mm
    serves 1x1 only. Returns the sums over one forward."""
    from onnx_rusty_inference_engine_tpu_torch.debug import intermediates

    card = intermediates(qgraph, {"image": x}, device="cuda",
                         params=eng8.params, packed=eng8.packed)
    tot = _vision_conv_lines("unet", qgraph, eng8, card, forwards,
                             grouped=False)
    head = [n for n in qgraph.nodes if n.op_type == "QLinearConv"
            and tuple(eng8.params[n.inputs[3]].shape[2:]) == (1, 1)]
    require(len(head) == 1, f"unet: one 1x1 QLinearConv, {len(head)}")
    a = card[head[0].inputs[0]]
    w = eng8.params[head[0].inputs[3]]
    a2 = a.permute(0, 2, 3, 1).reshape(-1, a.shape[1])
    b = torch.zeros(8, w.shape[1], dtype=torch.int8, device="cuda")
    b[:w.shape[0]] = w.reshape(w.shape[0], w.shape[1])
    library_ms = graph_ms(lambda: torch._int_mm(a2, b.t()), ITERS)
    del card
    torch.cuda.empty_cache()
    return {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "distinct_shapes": tot["distinct_shapes"],
            "library_ms": library_ms,
            "library": "torch._int_mm on the 1x1 head conv only ([B*H*W, "
                       f"{w.shape[1]}] x [{w.shape[1]}, 8], outputs padded "
                       "from 2); none for the 3x3 convs"}


# the detection_ml phase: bounded outputs, losses, RoI ops, ai.onnx.ml and
# the host stages at full width (seed 0 weights, default_rng(0) inputs)
ML = "ai.onnx.ml"
DET_BATCH = 8
DET_CPU_NMS = 2      # images whose card boxes and scores go through CPU NMS
TREES, TREE_DEPTH, TREE_FEATS = 500, 8, 28
TREE_BATCH, TREE_CPU = 4096, 256
SVM_CLASSES, SVM_FEATS, SVM_SV = 10, 784, 4000
SVM_BATCH, SVM_CPU = 1024, 128
TEXT_DOCS, TEXT_LEN, TEXT_VOCAB, TEXT_POOL, TEXT_CLASSES = 256, 200, 5000, \
    20000, 20
ROI_CPU = 64         # rois held against the CPU
LOSS_SHAPE = (8, 50257, 128)   # GPT-2's vocabulary over 128 positions
DML_ITERS = 5        # replays timed per path
DML_REL_TOL = 1e-5   # x max|ref|: detection boxes and scores


def _detection_config():
    from onnx_rusty_inference_engine_tpu_torch.models.detection import (
        DetectionConfig)

    return DetectionConfig(image_size=320, n_classes=80, anchors_per_cell=2,
                           backbone_ch=64, max_out=100, iou_threshold=0.5,
                           score_threshold=0.05)


def _one_node(op: str, feeds: dict, inits: dict = None, n_out: int = 1,
              domain: str = "", opset: int = 13, **attrs):
    """A one-node graph over `feeds` (inputs, in order) and `inits`
    (initializers, after them), as the port imports it."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models._builder import (
        GraphBuilder)

    b = GraphBuilder(op.lower(), opset=opset)
    names = [b.input(k, list(v.shape), v.dtype) for k, v in feeds.items()]
    names += [b.init(k, v) for k, v in (inits or {}).items()]
    outs = b.node(op, names, [f"out{i}" for i in range(n_out)],
                  domain=domain, **attrs)
    for o in outs:
        b.output(o)
    return P.import_model(b.model())


def _captured(graph, feed: dict) -> tuple:
    """An Engine on the card over `feed` (device tensors, or host values
    for a graph with a host prolog): its first call (eager, then captured)
    and its second (replayed), the replayed ms, and the peak device memory
    from the Engine's making to its replays."""
    import onnx_rusty_inference_engine_tpu_torch as P

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = P.Engine(graph)
    eager = eng(feed)
    replayed = eng(feed)
    ms = _graph_replay_ms(eng, DML_ITERS)
    return eng, eager, replayed, ms, torch.cuda.max_memory_allocated()


def _on_card(arrays: dict) -> dict:
    return {k: torch.as_tensor(v, device="cuda") for k, v in arrays.items()}


def _cpu(graph, feed: dict) -> dict:
    import onnx_rusty_inference_engine_tpu_torch as P

    return P.Engine(graph, device="cpu").run(feed).outputs


def _max_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _dml_line(path: str, t0: float, ms: float, peak: int, smi: str,
              **kw) -> None:
    emit({"phase": "detection_ml", "path": path, "replayed_ms": ms,
          "peak_bytes": peak, "peak_gb": peak / 1e9, **kw,
          "seconds": time.perf_counter() - t0, "card": smi})


def _dml_detection(smi: str) -> dict:
    """The SSD family at COCO's export settings, b8, in-graph NMS."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models.detection import (
        build_detection)

    t0 = time.perf_counter()
    cfg = _detection_config()
    S, C, M = cfg.n_boxes, cfg.n_classes, cfg.max_out
    x = np.random.default_rng(0).standard_normal(
        (DET_BATCH, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    dev = _on_card({"image": x})
    eng, eager, out, ms, peak = _captured(
        P.import_model(build_detection(cfg, batch=DET_BATCH)), dev)
    require(torch.equal(eager["selected_indices"], out["selected_indices"]),
            "detection: eager and replayed NMS rows equal")
    boxes = out["boxes"].cpu().numpy()
    scores = out["scores"].cpu().numpy()
    sel = out["selected_indices"].cpu().numpy()
    require(sel.shape == (DET_BATCH * C * M, 3)
            and sel.dtype == np.int32, f"detection rows {sel.shape}")
    ref = _cpu(P.import_model(build_detection(cfg, batch=1)),
               {"image": x[:1]})
    errs = {"boxes": _max_rel(boxes[:1], ref["boxes"]),
            "scores": _max_rel(scores[:1], ref["scores"])}
    for k, v in errs.items():
        require(v <= DML_REL_TOL, f"detection {k}: {v} > {DML_REL_TOL} x "
                f"max|ref|")
    # the NMS node bit for bit: the card's boxes and scores through the
    # port's NMS on the CPU give the card's rows
    k = DET_CPU_NMS
    nms = _one_node("NonMaxSuppression",
                    {"boxes": boxes[:k], "scores": scores[:k]},
                    {"max_out": np.array(M, np.int64),
                     "iou": np.array(cfg.iou_threshold, np.float32),
                     "score": np.array(cfg.score_threshold, np.float32)},
                    opset=11)
    t_nms = time.perf_counter()
    cpu_rows = _cpu(nms, {"boxes": boxes[:k], "scores": scores[:k]})["out0"]
    nms_cpu_s = time.perf_counter() - t_nms
    require(np.array_equal(cpu_rows, sel[:k * C * M]),
            f"detection: the card's NMS rows of the first {k} images equal "
            f"the CPU NMS on the card's boxes and scores")
    e2e = int((sel[:C * M] != ref["selected_indices"]).any(axis=1).sum())
    valid = sel[:, 0] >= 0
    for b in range(DET_BATCH):  # rows grouped (batch, class), -1 padding
        rows = sel[b * C * M:(b + 1) * C * M]
        require(((rows[:, 0] == b) | (rows[:, 0] == -1)).all()
                and (rows[rows[:, 0] < 0] == -1).all(),
                "detection: rows grouped by image, padding -1")
    # the NMS alone on the card's b8 boxes and scores, replayed
    _, _, nms_out, nms_ms, _ = _captured(
        _one_node("NonMaxSuppression", {"boxes": boxes, "scores": scores},
                  {"max_out": np.array(M, np.int64),
                   "iou": np.array(cfg.iou_threshold, np.float32),
                   "score": np.array(cfg.score_threshold, np.float32)},
                  opset=11), _on_card({"boxes": boxes, "scores": scores}))
    require(torch.equal(nms_out["out0"].cpu(), out["selected_indices"].cpu()),
            "detection: the NMS node alone gives the graph's rows")
    by_op, _ = _ms_by_op(eng, dev, 1)
    _dml_line("ssd_detection", t0, ms, peak, smi, config=vars(cfg),
              batch=DET_BATCH, boxes=S, rows=DET_BATCH * C * M,
              valid_rows=int(valid.sum()),
              images_per_s=DET_BATCH / ms * 1e3, nms_replayed_ms=nms_ms,
              iou_matrix_bytes_not_made=DET_BATCH * S * S * 4,
              max_rel_err_vs_cpu=errs,
              bound=f"boxes and scores {DML_REL_TOL} x max|ref| (image 0 "
                    f"against the CPU at b1); NMS rows equal",
              nms_rows_equal_images=k, nms_cpu_s=nms_cpu_s,
              e2e_rows_differing_image0=e2e, ms_by_op=by_op)
    del eng, eager, out, dev
    return {"ms": ms, "nms_ms": nms_ms, "peak": peak}


def _tree_graph(oplib, batch: int):
    """XGBoost's binary export behind sklearn's Imputer and Scaler, with
    ZipMap after: TREES trees of depth TREE_DEPTH, one-sided logistic.
    The ml ops take any batch: the CPU runs the same graph on fewer
    rows."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models._builder import (
        GraphBuilder)

    r = np.random.default_rng(0)
    attrs = oplib.forest_attrs(r, TREES, TREE_DEPTH, TREE_FEATS, 1,
                               kind="class", weight_scale=0.1)
    attrs["class_ids"] = [1] * len(attrs["class_ids"])
    mean = r.standard_normal(TREE_FEATS).astype(np.float32)
    std = r.uniform(0.5, 2.0, TREE_FEATS).astype(np.float32)
    b = GraphBuilder("xgboost_pipeline", opset=13)
    x = b.input("x", [batch, TREE_FEATS])
    b.node("Imputer", [x], ["x1"], domain=ML,
           imputed_value_floats=mean.tolist())
    b.node("Scaler", ["x1"], ["x2"], domain=ML, offset=mean.tolist(),
           scale=(1 / std).tolist())
    b.node("TreeEnsembleClassifier", ["x2"], ["label", "probabilities"],
           domain=ML, classlabels_int64s=[0, 1], post_transform="LOGISTIC",
           base_values=[0.1], **attrs)
    b.node("ZipMap", ["probabilities"], ["probs"], domain=ML,
           classlabels_int64s=[0, 1])
    for o in ("label", "probabilities", "probs"):
        b.output(o)
    return P.import_model(b.model()), mean, std


def _dml_trees(oplib, smi: str) -> dict:
    from onnx_rusty_inference_engine_tpu_torch.ops import ml

    t0 = time.perf_counter()
    graph, mean, std = _tree_graph(oplib, TREE_BATCH)
    r = np.random.default_rng(0)
    x = (r.standard_normal((TREE_BATCH, TREE_FEATS)) * std + mean).astype(
        np.float32)
    x[r.random(x.shape) < 0.02] = np.nan
    dev = _on_card({"x": x})
    eng, eager, out, ms, peak = _captured(graph, dev)
    require(torch.equal(eager["label"], out["label"]),
            "trees: eager and replayed labels equal")
    lab = out["label"].cpu().numpy()
    prob = out["probabilities"].cpu().numpy()
    maps = out["probs"]
    require(len(maps) == TREE_BATCH and all(
        m == {0: float(p[0]), 1: float(p[1])} for m, p in zip(maps, prob)),
        "trees: ZipMap's maps equal the probabilities")
    t1 = time.perf_counter()
    eng(dev)
    call_ms = (time.perf_counter() - t1) * 1e3
    ref = _cpu(graph, {"x": x[:TREE_CPU]})
    require(np.array_equal(lab[:TREE_CPU], ref["label"]),
            "trees: labels equal the CPU's")
    err = float(np.abs(prob[:TREE_CPU] - ref["probabilities"]).max())
    require(err <= DML_REL_TOL, f"trees: probabilities {err} > 1e-5")
    n_int, n_leaf = 2 ** TREE_DEPTH - 1, 2 ** TREE_DEPTH
    _dml_line("gradient_boosted_trees", t0, ms, peak, smi, trees=TREES,
              depth=TREE_DEPTH, features=TREE_FEATS, batch=TREE_BATCH,
              blocked=TREES * n_int * TREES * n_leaf > ml._BLOCKED_THRESHOLD,
              path_matrix_shape=[TREES, n_int, n_leaf],
              rows_per_s=TREE_BATCH / ms * 1e3, call_wall_ms=call_ms,
              max_abs_err_vs_cpu=err, labels_equal_rows=TREE_CPU,
              positive_share=float(lab.mean()),
              bound="labels equal, probabilities 1e-5, ZipMap = "
                    "probabilities")
    del eng, eager, out, dev
    return {"ms": ms, "peak": peak}


def _svm_graph(batch: int):
    """An RBF SVC at sklearn's gamma "scale" over 10 clusters of 784
    features, libsvm's layout (400 support vectors a class), with Platt
    scaling: probabilities by pairwise coupling; and its input. The CPU
    runs the same graph on fewer rows."""
    r = np.random.default_rng(0)
    K, F, nsv = SVM_CLASSES, SVM_FEATS, SVM_SV
    per = nsv // K
    centers = r.standard_normal((K, F)).astype(np.float32)
    sv = (np.repeat(centers, per, 0)
          + r.standard_normal((nsv, F))).astype(np.float32)
    alpha = np.abs(r.standard_normal((K - 1, nsv))).astype(np.float32) * 0.05
    coef = np.zeros((K - 1, nsv), np.float32)
    for i in range(K):       # class i's SVs: + against later classes
        cols = slice(i * per, (i + 1) * per)
        for j in range(K):
            if j != i:
                row = j - 1 if j > i else j
                coef[row, cols] = alpha[row, cols] * (1 if j > i else -1)
    n_pairs = K * (K - 1) // 2
    graph = _one_node(
        "SVMClassifier", {"x": np.zeros((batch, F), np.float32)}, n_out=2,
        domain=ML, classlabels_int64s=list(range(K)), kernel_type="RBF",
        kernel_params=[1.0 / F, 0.0, 3.0],
        support_vectors=sv.reshape(-1).tolist(),
        vectors_per_class=[per] * K, coefficients=coef.reshape(-1).tolist(),
        rho=(r.standard_normal(n_pairs) * 0.1).astype(np.float32).tolist(),
        prob_a=(-r.uniform(1.0, 2.0, n_pairs)).astype(np.float32).tolist(),
        prob_b=(r.standard_normal(n_pairs) * 0.1).astype(np.float32)
        .tolist())
    x = (centers[r.integers(0, K, SVM_BATCH)]
         + r.standard_normal((SVM_BATCH, F))).astype(np.float32)
    return graph, x


def _dml_svm(smi: str) -> dict:
    t0 = time.perf_counter()
    graph, x = _svm_graph(SVM_BATCH)
    dev = _on_card({"x": x})
    eng, eager, out, ms, peak = _captured(graph, dev)
    lab = out["out0"].cpu().numpy()
    prob = out["out1"].cpu().numpy()
    require(np.array_equal(eager["out0"].cpu().numpy(), lab),
            "svm: eager and replayed labels equal")
    ref = _cpu(graph, {"x": x[:SVM_CPU]})
    require(np.array_equal(lab[:SVM_CPU], ref["out0"]),
            "svm: labels equal the CPU's")
    err = float(np.abs(prob[:SVM_CPU] - ref["out1"]).max())
    require(err <= DML_REL_TOL, f"svm: probabilities {err} > 1e-5")
    require(np.allclose(prob.sum(-1), 1.0, atol=1e-4), "svm: distributions")
    _dml_line("svm_rbf_coupling", t0, ms, peak, smi, classes=SVM_CLASSES,
              pairs=SVM_CLASSES * (SVM_CLASSES - 1) // 2,
              features=SVM_FEATS, support_vectors=SVM_SV, batch=SVM_BATCH,
              rows_per_s=SVM_BATCH / ms * 1e3, max_abs_err_vs_cpu=err,
              labels_equal_rows=SVM_CPU,
              distinct_labels=int(len(np.unique(lab))),
              bound="labels equal, probabilities 1e-5")
    del eng, eager, out, dev
    return {"ms": ms, "peak": peak}


def _text_graph(batch: int):
    """sklearn's text pipeline: StringNormalizer (lower case) ->
    StringSplit -> TfIdfVectorizer (1- and 2-grams, TFIDF) ->
    LinearClassifier (softmax). StringNormalizer takes [C] or [1, C]
    strings only (the spec; host.py), so the documents enter as strings
    of TEXT_LEN space-joined tokens and StringSplit makes the
    [docs, TEXT_LEN] tokens."""
    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch.models._builder import (
        GraphBuilder)

    r = np.random.default_rng(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = sorted({"".join(r.choice(letters, n))
                    for n in r.integers(3, 9, 3 * TEXT_VOCAB)})
    vocab = [vocab[i] for i in r.permutation(len(vocab))[:TEXT_VOCAB]]
    freq = 1.0 / np.arange(1, TEXT_VOCAB + 1)        # Zipf's law
    freq /= freq.sum()
    n_bi = TEXT_POOL - TEXT_VOCAB
    pairs = r.choice(TEXT_VOCAB, (n_bi * 2, 2), p=freq)
    pairs = np.unique(pairs, axis=0)[:n_bi]
    pool = vocab + [vocab[i] for p in pairs for i in p]
    n_pool = TEXT_VOCAB + len(pairs)
    b = GraphBuilder("text_pipeline", opset=13)
    docs = b.input("docs", [batch], np.dtype(object))
    b.node("StringNormalizer", [docs], ["lower"],
           case_change_action="LOWER")
    b.node("StringSplit", ["lower"], ["tokens", "n_tokens"], delimiter=" ")
    b.node("TfIdfVectorizer", ["tokens"], ["tfidf"], mode="TFIDF",
           min_gram_length=1, max_gram_length=2, max_skip_count=0,
           ngram_counts=[0, TEXT_VOCAB], ngram_indexes=list(range(n_pool)),
           pool_strings=pool,
           weights=r.uniform(1.0, 5.0, n_pool).astype(np.float32).tolist())
    b.node("LinearClassifier", ["tfidf"], ["label", "probabilities"],
           domain=ML, classlabels_int64s=list(range(TEXT_CLASSES)),
           coefficients=(r.standard_normal(TEXT_CLASSES * n_pool) * 0.05)
           .astype(np.float32).tolist(),
           intercepts=(r.standard_normal(TEXT_CLASSES) * 0.1)
           .astype(np.float32).tolist(), post_transform="SOFTMAX")
    b.output("label")
    b.output("probabilities")
    words = np.array(vocab, dtype=object)[r.choice(
        TEXT_VOCAB, (TEXT_DOCS, TEXT_LEN), p=freq)]
    caps = r.random(words.shape)
    words = np.where(caps < 0.2, np.char.upper(words.astype(str)),
                     np.where(caps < 0.4, np.char.capitalize(
                         words.astype(str)), words.astype(str)))
    text = np.empty(TEXT_DOCS, dtype=object)
    text[:] = [" ".join(row) for row in words]
    return P.import_model(b.model()), text, n_pool


def _dml_text(smi: str) -> dict:
    t0 = time.perf_counter()
    graph, text, n_pool = _text_graph(TEXT_DOCS)
    feed = {"docs": text}
    eng, eager, out, ms, peak = _captured(graph, feed)
    require(eng._host is not None and eng._host.boundary == ["tfidf"],
            "text: the prolog hands TF-IDF to the device")
    t1 = time.perf_counter()
    dev_feed, _ = eng._host.split_feed(feed, eng.graph.input_names,
                                       lambda v: v)
    prolog_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    eng(feed)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t1) * 1e3
    lab = out["label"].cpu().numpy()
    prob = out["probabilities"].cpu().numpy()
    require(np.array_equal(eager["label"].cpu().numpy(), lab),
            "text: eager and replayed labels equal")
    ref = _cpu(graph, feed)
    require(np.array_equal(lab, ref["label"]), "text: labels equal the CPU's")
    err = float(np.abs(prob - ref["probabilities"]).max())
    require(err <= DML_REL_TOL, f"text: probabilities {err} > 1e-5")
    nnz = int((dev_feed["tfidf"] != 0).sum())
    _dml_line("text_pipeline", t0, ms, peak, smi, docs=TEXT_DOCS,
              tokens_per_doc=TEXT_LEN, vocabulary=TEXT_VOCAB, pool=n_pool,
              classes=TEXT_CLASSES, tfidf_nonzeros=nnz,
              host_prolog_ms=prolog_ms, device_replayed_ms=ms,
              call_wall_ms=call_ms, docs_per_s=TEXT_DOCS / call_ms * 1e3,
              max_abs_err_vs_cpu=err, bound="labels equal, probabilities "
                                            "1e-5 (whole batch)")
    del eng, eager, out
    return {"ms": ms, "prolog_ms": prolog_ms, "peak": peak}


def _rois(r, n: int, height: int, width: int, batch: int) -> tuple:
    """n boxes (x1, y1, x2, y2) inside a height x width image, 16-400
    pixels a side, and their image indices."""
    wh = r.uniform(16, 400, (n, 2))
    lo = r.uniform(0, 1, (n, 2)) * np.maximum([width, height] - wh, 1)
    boxes = np.concatenate([lo, lo + wh], 1).astype(np.float32)
    return boxes, r.integers(0, batch, n).astype(np.int64)


def _dml_roi(smi: str) -> dict:
    """RoiAlign on FPN's P2 (800 x 1088 images, stride 4), MaxRoiPool on
    VGG's conv5 (stride 16), DeformConv v2 at a detector neck's widths."""
    r = np.random.default_rng(0)
    res = {}
    t0 = time.perf_counter()
    x = r.standard_normal((2, 256, 200, 272)).astype(np.float32)
    rois, bidx = _rois(r, 1000, 800, 1088, 2)
    attrs = dict(output_height=7, output_width=7, sampling_ratio=2,
                 spatial_scale=0.25, mode="avg")
    feeds = {"x": x, "rois": rois, "b": bidx}
    _, eager, out, ms, peak = _captured(
        _one_node("RoiAlign", feeds, opset=16, **attrs), _on_card(feeds))
    small = {"x": x, "rois": rois[:ROI_CPU], "b": bidx[:ROI_CPU]}
    want = _cpu(_one_node("RoiAlign", small, opset=16, **attrs),
                small)["out0"]
    got = out["out0"][:ROI_CPU].cpu().numpy()
    require(np.allclose(got, want, rtol=1e-4, atol=1e-5)
            and np.allclose(eager["out0"][:ROI_CPU].cpu().numpy(), want,
                            rtol=1e-4, atol=1e-5),
            f"roi_align: the first rois against the CPU (rtol 1e-4, atol "
            f"1e-5): max |d| {np.abs(got - want).max()}")
    _dml_line("roi_align", t0, ms, peak, smi, features=list(x.shape),
              rois=len(rois), **attrs, rois_per_s=len(rois) / ms * 1e3,
              max_abs_err_vs_cpu=float(np.abs(got - want).max()),
              bound=f"rtol 1e-4, atol 1e-5 on the first {ROI_CPU} rois")
    res["roi_align_ms"] = ms
    res["peak"] = peak

    t0 = time.perf_counter()
    x = r.standard_normal((1, 512, 38, 50)).astype(np.float32)
    boxes, _ = _rois(r, 300, 608, 800, 1)
    rois = np.concatenate([np.zeros((300, 1), np.float32), boxes], 1)
    attrs = dict(pooled_shape=[7, 7], spatial_scale=1 / 16)
    feeds = {"x": x, "rois": rois}
    _, eager, out, ms, peak = _captured(
        _one_node("MaxRoiPool", feeds, **attrs), _on_card(feeds))
    small = {"x": x, "rois": rois[:ROI_CPU]}
    want = _cpu(_one_node("MaxRoiPool", small, **attrs), small)["out0"]
    got = out["out0"][:ROI_CPU].cpu().numpy()
    require(np.allclose(got, want, rtol=1e-5, atol=1e-6)
            and np.allclose(eager["out0"][:ROI_CPU].cpu().numpy(), want,
                            rtol=1e-5, atol=1e-6),
            f"max_roi_pool: the first rois against the CPU: max |d| "
            f"{np.abs(got - want).max()}")
    _dml_line("max_roi_pool", t0, ms, peak, smi, features=list(x.shape),
              rois=len(rois), **attrs, rois_per_s=len(rois) / ms * 1e3,
              max_abs_err_vs_cpu=float(np.abs(got - want).max()),
              bound=f"rtol 1e-5, atol 1e-6 on the first {ROI_CPU} rois")
    res["max_roi_pool_ms"] = ms
    res["peak"] = max(res["peak"], peak)

    t0 = time.perf_counter()
    N, C, H, W, M = 8, 256, 50, 68, 256
    feeds = {"x": r.standard_normal((N, C, H, W)).astype(np.float32),
             "off": (r.standard_normal((N, 18, H, W)) * 2).astype(
                 np.float32),
             "mask": r.uniform(0, 1, (N, 9, H, W)).astype(np.float32)}
    inits = {"w": (r.standard_normal((M, C, 3, 3)) * (9 * C) ** -0.5
                   ).astype(np.float32),
             "b": (r.standard_normal(M) * 0.1).astype(np.float32)}
    attrs = dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])

    def deform(f):
        import onnx_rusty_inference_engine_tpu_torch as P
        from onnx_rusty_inference_engine_tpu_torch.models._builder import (
            GraphBuilder)

        b = GraphBuilder("deform_conv", opset=19)
        for k, v in f.items():
            b.input(k, list(v.shape))
        for k, v in inits.items():
            b.init(k, v)
        b.node("DeformConv", ["x", "w", "off", "b", "mask"], ["out0"],
               **attrs)
        b.output("out0")
        return P.import_model(b.model())

    _, eager, out, ms, peak = _captured(deform(feeds), _on_card(feeds))
    small = {k: v[:1] for k, v in feeds.items()}
    want = _cpu(deform(small), small)["out0"]
    got = out["out0"][:1].cpu().numpy()
    require(np.allclose(got, want, rtol=1e-3, atol=1e-4)
            and np.allclose(eager["out0"][:1].cpu().numpy(), want,
                            rtol=1e-3, atol=1e-4),
            f"deform_conv: the first image against the CPU: max |d| "
            f"{np.abs(got - want).max()}")
    _dml_line("deform_conv_v2", t0, ms, peak, smi, x=[N, C, H, W],
              out_channels=M, **attrs, images_per_s=N / ms * 1e3,
              tflops=2 * N * M * C * 9 * H * W / ms / 1e9,
              max_abs_err_vs_cpu=float(np.abs(got - want).max()),
              bound="rtol 1e-3, atol 1e-4 on the first image")
    res["deform_conv_ms"] = ms
    res["peak"] = max(res["peak"], peak)
    return res


def _dml_loss(smi: str) -> dict:
    t0 = time.perf_counter()
    r = np.random.default_rng(0)
    B, V, T = LOSS_SHAPE
    s = r.standard_normal(LOSS_SHAPE).astype(np.float32)
    t = r.integers(0, V, (B, T)).astype(np.int64)
    t[r.random((B, T)) < 0.1] = -100
    feeds = {"s": s, "t": t}
    graph = _one_node("SoftmaxCrossEntropyLoss", feeds, opset=13,
                      reduction="mean", ignore_index=-100)
    _, eager, out, ms, peak = _captured(graph, _on_card(feeds))
    want = float(_cpu(graph, feeds)["out0"])
    got = float(out["out0"])
    rel = abs(got - want) / abs(want)
    require(rel <= 2e-5 and abs(float(eager["out0"]) - want)
            <= 2e-5 * abs(want), f"loss: {got} against the CPU's {want}")
    _dml_line("softmax_cross_entropy", t0, ms, peak, smi,
              scores=list(LOSS_SHAPE), ignored=int((t == -100).sum()),
              loss=got, rel_err_vs_cpu=rel, gb_per_s=s.nbytes / ms / 1e6,
              bound="rtol 2e-5")
    return {"ms": ms, "peak": peak}


def phase_detection_ml(smi: str) -> dict:
    """Bounded outputs, losses, RoI ops, ai.onnx.ml and the host stages at
    full width, each forward one captured graph, replayed: the SSD family
    at COCO's export settings with in-graph NMS, XGBoost's binary trees
    behind sklearn's Imputer and Scaler with ZipMap after, an RBF SVC with
    Platt coupling, a text pipeline with a host prolog, RoI heads
    (RoiAlign, MaxRoiPool, DeformConv v2) and GPT-2's vocabulary's
    cross-entropy; each against the port's CPU run (see each path's
    bound), with its replayed ms and peak device memory."""
    oplib = _oplib()
    t0 = time.perf_counter()
    res = {"detection": _dml_detection(smi)}
    torch.cuda.empty_cache()
    res["trees"] = _dml_trees(oplib, smi)
    torch.cuda.empty_cache()
    res["svm"] = _dml_svm(smi)
    res["text"] = _dml_text(smi)
    torch.cuda.empty_cache()
    res["roi"] = _dml_roi(smi)
    torch.cuda.empty_cache()
    res["loss"] = _dml_loss(smi)
    torch.cuda.empty_cache()
    peak = max(v["peak"] for v in res.values())
    require(peak < 25e9, f"detection_ml: peak {peak / 1e9} GB")
    emit({"phase": "detection_ml", "seconds": time.perf_counter() - t0,
          "peak_gb": peak / 1e9})
    return res


# --------------------------------------------------------------------------
# families: multi-LoRA GPT-2, the MoE decoder, T5-small and Whisper-style
# ASR through Seq2SeqGenerator, and the INT8 accuracy benchmark
# --------------------------------------------------------------------------
LORA_ADAPTERS, LORA_RANK, LORA_ALPHA = 8, 16, 16.0
LORA_NEW = 16
LORA_FOLD_SEQ = 128        # the fp32 prefill held against fold_adapter
MOE_LAYERS = 2             # of GPT-2 small's 12: the depth cut
MOE_PROMPT, MOE_NEW, MOE_LOOP = 128, 16, 8
MOE_DECODE_CHECK = 8       # decode steps held against the prefill
T5_BATCH, T5_SRC, T5_MAX, T5_NEW = 16, 512, 128, 32
ASR_BATCH, ASR_SAMPLES, ASR_MAX, ASR_NEW = 8, 480000, 32, 32
ACC_MODEL, ACC_BATCHES, ACC_BATCH = "squeezenet", 8, 32
FAM_REL_TOL = 1e-5         # x max|ref|: the card against the CPU
# T5 scores are unscaled and its embeddings of std 1, so its encoder
# amplifies rounding: at t5-small's widths an fp32 run is ~3e-5 x max from
# a float64 one, and the JAX and PyTorch encoders part by 3.9e-5 on the CPU
# (tests/test_torch_port_seq2seq.py::test_t5_small_encoder_parts_on_the_cpu;
# the t5 line prints the card's and the CPU's distance from float64, and
# the card's error with TF32 on)
T5_REL_TOL = 1e-4
NEAR_TIE = 1e-3            # x the logits' range: one INT8 KV code's reach


def _fam_line(path: str, t0: float, smi: str, **kw) -> None:
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "families", "path": path, **kw, "peak_bytes": peak,
          "peak_gb": peak / 1e9, "seconds": time.perf_counter() - t0,
          "card": smi})


def _mm_nbits(graph) -> int:
    return sum(n.op_type == "MatMulNBits" for n in graph.nodes)


def _wall(fn) -> tuple:
    """(fn(), wall seconds of a synchronized run)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _with_scales(gen, scales: dict):
    """gen with the server's KV scales: a server calibrates its cache from
    its first prompt, an isolated Generator from its own; with one set of
    scales both quantize the same K/V to the same bytes."""
    gen._kv_scales = dict(scales)
    return gen


def _served_vs_isolated(what: str, served: list, prompts, gen) -> dict:
    """Each served request's tokens against the isolated Generator `gen`
    (batch 1, on the server's KV scales), teacher-forced on the served
    tokens: at every step gen's own greedy pick must be the served token,
    or else the pick is a near-tie (gen's top-2 margin under NEAR_TIE of
    its logits' range). The server decodes its slots at M = 8 and gen at
    M = 1, and the card's products may sum in another order at another
    M; through the INT8 cache, a last-bit difference can move a K/V code
    by one step. Returns the picks checked and the near-ties met."""
    picks, ties = 0, []
    for k, got in enumerate(served):
        logits, cache = gen.start(prompts[k][None])
        lg = logits[:, -1]
        for t, tok in enumerate(got):
            if t:
                lg, cache = gen.step(cache, torch.tensor(
                    [got[t - 1]], device=gen.device), prompts.shape[1] + t - 1)
                lg = lg[:, -1]
            row = lg.cpu().numpy()[0]
            picks += 1
            if int(row.argmax()) != int(tok):
                top2 = np.sort(row)[-2:]
                margin = float((top2[1] - top2[0]) / (row.max() - row.min()))
                ties.append({"request": k, "step": t, "rel_margin": margin})
                require(margin < NEAR_TIE, f"{what}: request {k}'s served "
                        f"token {t} is not its isolated pick (margin "
                        f"{margin})")
    return {"picks": picks, "near_ties": ties}


def _fam_lora(gen, prompts, smi: str) -> dict:
    """GPT-2 124M with a multi-LoRA bank on phase 6's path."""
    from onnx_rusty_inference_engine_tpu_torch.engine import Engine
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model
    from onnx_rusty_inference_engine_tpu_torch.lora import (
        attach_lora, fold_adapter, make_adapter_stack)
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import build_gpt2
    from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, B, P = gen.cfg, prompts.shape[0], prompts.shape[1]
    bank = make_adapter_stack(
        import_model(build_gpt2(cfg, batch=1, seq_len=8,
                                with_presents=False)),
        n_adapters=LORA_ADAPTERS, rank=LORA_RANK, targets=("attn", "mlp"),
        seed=0)
    lkw = dict(lora_bank=bank, lora_alpha=LORA_ALPHA, kv_dtype="int8",
               int4_weights=True, device="cuda")
    # (a) adapter 0 on every row: phase 6's base Generator, bit for bit
    lgen = Generator(cfg, batch=B, prompt_len=P, max_len=gen.max_len,
                     fused_attention=True, adapter=0, **lkw)
    n4, n4_pre = _mm_nbits(lgen.decode.graph), _mm_nbits(lgen.prefill.graph)
    n_attn = sum(n.op_type == "FusedDecodeAttention"
                 for n in lgen.decode.graph.nodes)
    require(n4 == _mm_nbits(gen.decode.graph) == 4 * cfg.n_layer + 1
            and n_attn == cfg.n_layer, f"lora: {n4} int4, {n_attn} attention")
    want_toks, want_logits = gen.generate(prompts, LORA_NEW,
                                          return_logits=True)
    reset_counts()
    toks, logits = lgen.generate(prompts, LORA_NEW, return_logits=True)
    counts = read_counts()
    steps = LORA_NEW - 1
    require(all(np.array_equal(a, b) for a, b in zip(logits, want_logits))
            and np.array_equal(toks, want_toks),
            "lora: adapter 0's logits bit for bit those of the base")
    require(counts["qmatmul_int4_planar"] == n4_pre + n4 * steps
            and counts["decode_attention_int8"] == n_attn * steps,
            f"lora: 49 int4 and 12 attention launches per step: {counts}")
    _, wall = _wall(lambda: lgen.generate(prompts, LORA_NEW))
    _, wall_base = _wall(lambda: gen.generate(prompts, LORA_NEW))
    del lgen
    # (b) one request per adapter through an 8-slot server, each against
    # an isolated Generator on its adapter
    srv = DecodeServer(cfg, slots=LORA_ADAPTERS, prompt_len=P,
                       max_len=P + LORA_NEW, **lkw)
    try:
        futs = [srv.submit(prompts[k % B], LORA_NEW, adapter=k)
                for k in range(LORA_ADAPTERS)]
        served, swall = _wall(lambda: [f.result(timeout=600)
                                        for f in futs])
        scales = srv._kv_scales
    finally:
        srv.stop()
    iso = _with_scales(Generator(cfg, batch=1, prompt_len=P,
                                 max_len=P + LORA_NEW, **lkw), scales)
    vs_iso = {"picks": 0, "near_ties": []}
    for k in range(LORA_ADAPTERS):
        iso._lora_idx.fill_(k)
        one = _served_vs_isolated("lora", served[k:k + 1],
                                  prompts[k % B:k % B + 1], iso)
        vs_iso["picks"] += one["picks"]
        vs_iso["near_ties"] += [dict(t, request=k)
                                for t in one["near_ties"]]
    # the control: the last request's tokens are not adapter 0's picks
    iso._lora_idx.fill_(0)
    k = LORA_ADAPTERS - 1
    logits, cache = iso.start(prompts[k % B][None])
    control = int(logits[0, -1].argmax() != served[k][0])
    for t in range(1, LORA_NEW):
        lg, cache = iso.step(cache, torch.tensor([served[k][t - 1]],
                                                 device=iso.device), P + t - 1)
        control += int(lg[0, -1].argmax() != served[k][t])
    require(control > 0, "lora: the adapters change the picks")
    del iso
    # (c) fp32 base, one prefill: adapter k's rows against fold_adapter(k)
    g = import_model(build_gpt2(cfg, batch=LORA_ADAPTERS,
                                seq_len=LORA_FOLD_SEQ, with_presents=False))
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LORA_ADAPTERS, LORA_FOLD_SEQ)), device="cuda")
    with torch.no_grad():
        out = Engine(attach_lora(g, bank, alpha=LORA_ALPHA),
                     device="cuda").forward({
            "input_ids": ids, "lora_idx": torch.arange(
                LORA_ADAPTERS, device="cuda")})["logits"]
        base = Engine(g, device="cuda")
        fold_err = []
        for k in range(LORA_ADAPTERS):
            ref = Engine(fold_adapter(g, bank, k, alpha=LORA_ALPHA),
                         device="cuda", share_params_with=base).forward(
                {"input_ids": ids})["logits"][k]
            fold_err.append(_rel_err(out[k], ref))
    del base
    require(max(fold_err) <= 1e-4, f"lora vs fold_adapter: {fold_err}")
    _fam_line("multi_lora_gpt2", t0, smi, model="gpt2 124M (seed 0)",
              bank={"adapters": LORA_ADAPTERS, "rank": LORA_RANK,
                    "targets": len(bank), "alpha": LORA_ALPHA},
              batch=B, prompt=P, new_tokens=LORA_NEW,
              adapter0_bit_equal=True, launches=counts,
              per_step={"qmatmul_int4_planar": n4,
                        "decode_attention_int8": n_attn},
              tokens_per_s=B * LORA_NEW / wall,
              base_tokens_per_s=B * LORA_NEW / wall_base,
              served_tokens_per_s=LORA_ADAPTERS * LORA_NEW / swall,
              served_vs_isolated=vs_iso,
              control_picks_unlike_adapter0=control,
              fold_rel_err=fold_err, bound="1e-4 x max|ref|")
    return {"qmatmul_int4_planar": {
                "launches": counts["qmatmul_int4_planar"], "per_step": n4},
            "decode_attention_int8": {
                "launches": counts["decode_attention_int8"],
                "per_step": n_attn}}


def _device_loop_logits(gen, prompts, n_new: int) -> tuple:
    """gen.generate(prompts, n_new) on its device loop, with the logits of
    every pick: (tokens, logits [n_new, B, V], the buffers). Each pick's
    logits are copied, inside the blocks' graph, into row `at % rows` of a
    buffer, `at` counting on the device, so the replays record them too.
    The graph keeps writing there on later replays: the caller holds the
    buffers as long as gen."""
    rows = n_new + gen.device_loop
    buf = torch.zeros((rows, gen.batch, gen.cfg.vocab_size),
                      device=gen.device)
    at = torch.zeros((1,), dtype=torch.int64, device=gen.device)
    select = gen._select

    def recording(logits, *args, **kw):
        buf.index_copy_(0, torch.remainder(at, rows),
                        logits[None].to(torch.float32))
        at.add_(1)
        return select(logits, *args, **kw)

    gen._select = recording
    try:
        toks, _ = gen.generate(prompts, n_new)
    finally:
        del gen._select
    return toks, buf[:n_new].cpu().numpy(), (buf, at)


def _moe_config():
    from onnx_rusty_inference_engine_tpu_torch.models.moe import MoEConfig

    return MoEConfig(vocab_size=50257, n_positions=1024, n_embd=768,
                     n_head=12, n_expert=8, d_ff=3072, n_layer=MOE_LAYERS)


def _fam_moe(smi: str) -> dict:
    """GPT-2 small's widths with Switch-base-8's experts, MOE_LAYERS deep."""
    from onnx_rusty_inference_engine_tpu_torch.engine import Engine
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model
    from onnx_rusty_inference_engine_tpu_torch.models.moe import build_moe
    from onnx_rusty_inference_engine_tpu_torch.serving import DecodeServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = _moe_config()
    B, P, ML = 8, MOE_PROMPT, MOE_PROMPT + MOE_NEW
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P))
    ids = torch.as_tensor(prompts, device="cuda")
    # fp32 weights: the prefill against the CPU, the routing, and the
    # cached decode against the prefill
    g32 = Generator(cfg, family="moe", batch=B, prompt_len=P, max_len=ML,
                    device="cuda")
    with torch.no_grad():
        pre = g32.prefill.forward({"input_ids": ids})
        cpu = Engine(import_model(build_moe(
            cfg, batch=FAMILY_CPU, seq_len=P, with_presents=True)),
            device="cpu").run({"input_ids": prompts[:FAMILY_CPU]}).outputs
        n_cpu = FAMILY_CPU * P
        pre_err = _rel_err(pre["logits"][:FAMILY_CPU], cpu["logits"])
        hist, margin, route_equal = [], [], True
        for i in range(cfg.n_layer):
            rp = pre[f"router_probs_{i}"].cpu().numpy()
            hist.append(np.bincount(rp.argmax(-1),
                                    minlength=cfg.n_expert).tolist())
            top2 = np.sort(rp, axis=-1)[:, -2:]
            margin.append(float((top2[:, 1] - top2[:, 0]).min()))
            route_equal &= bool(np.array_equal(
                rp[:n_cpu].argmax(-1), cpu[f"router_probs_{i}"].argmax(-1)))
        require(pre_err <= FAM_REL_TOL,
                f"moe prefill vs the CPU: {pre_err} (routing equal: "
                f"{route_equal}, smallest margins {margin})")
        cache = {s.name: torch.zeros(s.concrete_shape(batch=B),
                                     device="cuda")
                 for s in g32.decode.graph.inputs
                 if s.name.startswith("past_")}
        dec_err = []
        for t in range(MOE_DECODE_CHECK):
            o = g32.decode.forward({
                "input_ids": ids[:, t:t + 1].contiguous(),
                "pos": torch.full((B,), t, dtype=torch.int64,
                                  device="cuda"), **cache})
            cache = {k: o[k.replace("past_", "present_")] for k in cache}
            dec_err.append(_rel_err(o["logits"][:, 0], pre["logits"][:, t]))
        require(max(dec_err) <= 1e-4, f"moe decode vs prefill: {dec_err}")
    del g32, pre, cache, o
    # INT4 weights + INT8 KV: the host loop and the device loop
    gen = Generator(cfg, family="moe", batch=B, prompt_len=P, max_len=ML,
                    kv_dtype="int8", int4_weights=True,
                    device_loop=MOE_LOOP, device="cuda")
    n4, n4_pre = _mm_nbits(gen.decode.graph), _mm_nbits(gen.prefill.graph)
    reset_counts()
    host_toks, host_logits = gen.generate(prompts, MOE_NEW,
                                          return_logits=True)
    counts = read_counts()
    require(counts["qmatmul_int4_planar"] == n4_pre + n4 * (MOE_NEW - 1),
            f"moe: {n4} int4 launches per step: {counts}")
    loop_toks, loop_logits, held = _device_loop_logits(gen, prompts,
                                                       MOE_NEW)
    want = np.stack([host_logits[0][:, -1]]
                    + [x[:, -1] for x in host_logits[1:]])
    require(np.array_equal(loop_toks, host_toks)
            and np.array_equal(loop_logits, want),
            "moe: device_loop tokens and logits bit for bit the host loop's")
    _, wall_loop = _wall(lambda: gen.generate(prompts, MOE_NEW))
    gen.device_loop = 0
    try:
        _, wall_host = _wall(lambda: gen.generate(prompts, MOE_NEW))
    finally:
        gen.device_loop = MOE_LOOP
    del gen, held
    # the server against isolated runs (on the server's KV scales)
    srv = DecodeServer(cfg, family="moe", slots=B, prompt_len=P,
                       max_len=ML, kv_dtype="int8", int4_weights=True,
                       device="cuda")
    try:
        futs = [srv.submit(prompts[k], MOE_NEW) for k in range(B)]
        served, swall = _wall(lambda: [f.result(timeout=600)
                                        for f in futs])
        scales = srv._kv_scales
    finally:
        srv.stop()
    iso = _with_scales(Generator(cfg, family="moe", batch=1, prompt_len=P,
                                 max_len=ML, kv_dtype="int8",
                                 int4_weights=True, device="cuda"), scales)
    vs_iso = _served_vs_isolated("moe", served, prompts, iso)
    del iso
    _fam_line("moe_decoder", t0, smi, model=dataclasses.asdict(cfg),
              depth_cut=f"{cfg.n_layer} of 12 layers", batch=B, prompt=P,
              new_tokens=MOE_NEW, prefill_rel_err_vs_cpu=pre_err,
              routing_equal_cpu=route_equal, expert_histogram=hist,
              smallest_router_margin=margin, decode_vs_prefill=dec_err,
              launches=counts, int4_per_step=n4, int4_per_prefill=n4_pre,
              device_loop=MOE_LOOP, device_loop_logits_bit_equal=True,
              tokens_per_s_host_loop=B * MOE_NEW / wall_host,
              tokens_per_s_device_loop=B * MOE_NEW / wall_loop,
              served_tokens_per_s=B * MOE_NEW / swall,
              served_vs_isolated=vs_iso, bound="1e-5 x max|ref|")
    return {"qmatmul_int4_planar": {
        "launches": counts["qmatmul_int4_planar"], "per_step": n4}}


def _teacher_forced(gen, src, toks, rows: int) -> tuple:
    """gen encodes src and steps through the reference's greedy tokens
    (row r takes the reference's row r % rows): (encoder outputs, the
    logits of every step)."""
    enc = gen.start(src)
    B = src.shape[0]
    feed = np.zeros((B,), np.int64)
    logits = []
    for t in range(toks.shape[1]):
        logits.append(gen.step(torch.as_tensor(
            feed, device=gen.device)).cpu().numpy()[:rows, 0])
        feed = toks[np.arange(B) % rows, t]
    return enc, logits


def _cpu_greedy(gen, src, n_new: int) -> tuple:
    """The CPU's greedy run through start/step: (encoder outputs, tokens
    [rows, n_new], logits of every step)."""
    enc = gen.start(src)
    tok = torch.zeros((src.shape[0],), dtype=torch.int64)
    toks, logits = [], []
    for _ in range(n_new):
        lg = gen.step(tok)[:, 0]
        logits.append(lg.numpy())
        tok = lg.argmax(-1)
        toks.append(tok.numpy())
    return enc, np.stack(toks, 1), logits


def _int8_switch(gen, src, n_new: int) -> tuple:
    """gen.generate(src, n_new) with its switch to int8 recorded: (tokens,
    the wall seconds, the int8 cache and scales byte for byte those of
    numpy's quantization, the JAX formula, of the card's own fp32 cache)."""
    seen = {}
    real = gen.quantize_cache

    def spy(amax, cache):
        scales, q = real(amax, cache)
        seen.update(fp32={k: v.cpu().numpy() for k, v in cache.items()},
                    scales={k: v.cpu().numpy() for k, v in scales.items()},
                    q={k: v.cpu().numpy() for k, v in q.items()})
        return scales, q

    gen.quantize_cache = spy
    try:
        toks, wall = _wall(lambda: gen.generate(src, n_new))
    finally:
        del gen.quantize_cache
    n_bytes = 0
    for name, kv in seen["fp32"].items():
        _, kind, i = name.split("_")
        amax = np.abs(kv).max(axis=(0, 2, 3))
        s = (np.maximum(amax, 1e-6) / 127.0).astype(np.float32)
        q = np.clip(np.round(kv / s.reshape(1, -1, 1, 1)), -127,
                    127).astype(np.int8)
        require(seen["scales"][f"kv_scale_{kind}_{i}"].tobytes()
                == s.tobytes() and seen["q"][name].tobytes() == q.tobytes(),
                f"{name}: the int8 switch byte for byte numpy's")
        n_bytes += q.nbytes
    return toks[0], wall, n_bytes


def _t5_floor(gen, cpu_graph, src, cpu_enc: dict, enc: dict,
              rows: int) -> dict:
    """Why T5 is held at T5_REL_TOL: the first rows' encoder outputs
    against a float64 run of the same graph on the CPU, from the CPU's
    fp32 run and from the card's (two fp32 runs, each its own distance
    from the exact result); and the card's encoder with TF32 on in its
    MatMul emitters (ops.standard's matmul_fp32_exact a no-op under
    _tf32()) against the CPU's fp32 run: the error that the bound is
    there to catch."""
    from onnx_rusty_inference_engine_tpu_torch.engine import Engine
    from onnx_rusty_inference_engine_tpu_torch.ops import standard

    B, S = src.shape
    exact = Engine(dataclasses.replace(cpu_graph, constants={
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in cpu_graph.constants.items()}), device="cpu").run({
            "src_ids": src[:rows],
            "src_len": np.full((rows,), S, np.int64)}).outputs
    real = standard.matmul_fp32_exact
    standard.matmul_fp32_exact = contextlib.nullcontext
    try:
        with _tf32():
            tf32 = gen.encoder.forward({
                "src_ids": torch.as_tensor(src, device="cuda"),
                "src_len": torch.full((B,), S, dtype=torch.int64,
                                      device="cuda")})
    finally:
        standard.matmul_fp32_exact = real
    return {"cpu_fp32_vs_f64": max(_rel_err(cpu_enc[k], v)
                                   for k, v in exact.items()),
            "card_vs_f64": max(_rel_err(enc[k][:rows], v)
                               for k, v in exact.items()),
            "card_tf32_vs_cpu": max(_rel_err(tf32[k][:rows], v)
                                    for k, v in cpu_enc.items())}


def _fam_seq2seq(family: str, cfg, src, max_len: int, n_new: int,
                 smi: str, int4: bool) -> dict:
    """One encoder-decoder family on the card: (i) fp32, its first rows'
    encoder outputs and teacher-forced logits against the CPU; (ii) INT8
    KV (calib_steps 4, with int4 weights where `int4`), the switch byte
    for byte, int4 launches per encoder call and per step."""
    from onnx_rusty_inference_engine_tpu_torch.generate import (
        Seq2SeqGenerator)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    B, S = src.shape
    rows = FAMILY_CPU if family == "t5" else 1
    kw = dict(family=family, src_len=S, max_len=max_len)
    cpu = Seq2SeqGenerator(cfg, batch=rows, device="cpu", **kw)
    cpu_enc, cpu_toks, cpu_logits = _cpu_greedy(cpu, src[:rows], n_new)
    cpu_graph = cpu.encoder.graph
    del cpu
    gen = Seq2SeqGenerator(cfg, batch=B, device="cuda", **kw)
    enc, logits = _teacher_forced(gen, src, cpu_toks, rows)
    enc_err = {k: _rel_err(enc[k][:rows], v) for k, v in cpu_enc.items()}
    step_err = [_rel_err(a, b) for a, b in zip(logits, cpu_logits)]
    tol = T5_REL_TOL if family == "t5" else FAM_REL_TOL
    require(max(enc_err.values()) <= tol and max(step_err) <= tol,
            f"{family}: encoder {enc_err}, steps {step_err}")
    floor = (_t5_floor(gen, cpu_graph, src, cpu_enc, enc, rows)
             if family == "t5" else {})
    gen.generate(src, n_new)                     # captures the step
    (toks32, _), wall32 = _wall(lambda: gen.generate(src, n_new))
    del gen
    q = Seq2SeqGenerator(cfg, batch=B, device="cuda", kv_dtype="int8",
                         calib_steps=4, int4_weights=int4, **kw)
    n_enc, n_dec = _mm_nbits(q.encoder.graph), _mm_nbits(q.decode.graph)
    require(n_dec == _mm_nbits(q.decode_fp32.graph), "shadow int4 count")
    reset_counts()
    toks8, _, n_bytes = _int8_switch(q, src, n_new)
    counts = read_counts()
    require(counts["qmatmul_int4_planar"] == n_enc + n_dec * n_new,
            f"{family}: {n_enc} int4 per encoder call, {n_dec} per step: "
            f"{counts}")
    _, wall8 = _wall(lambda: q.generate(src, n_new))
    del q
    unit = "tokens" if family == "t5" else "clips"
    rate = (lambda w: B * n_new / w) if family == "t5" else \
        (lambda w: B / w)
    line = dict(batch=B, src_len=S, max_len=max_len, new_tokens=n_new,
                enc_rel_err_vs_cpu=enc_err,
                teacher_forced_max_rel_err=max(step_err),
                int8_switch_byte_equal=n_bytes, launches=counts,
                int4_per_encoder_call=n_enc, int4_per_step=n_dec,
                int8_agree_fp32=float((toks8 == toks32).mean()),
                bound=f"{tol} x max|ref|", **floor,
                **{f"{unit}_per_s_fp32": rate(wall32),
                   f"{unit}_per_s_int8": rate(wall8)})
    _fam_line(family, t0, smi, model=dataclasses.asdict(cfg), **line)
    if not counts["qmatmul_int4_planar"]:
        return {}
    return {"qmatmul_int4_planar": {
        "launches": counts["qmatmul_int4_planar"],
        "per_encoder_call": n_enc, "per_step": n_dec}}


def _fam_accuracy(smi: str) -> dict:
    """The port's benchmarks/accuracy.py on SqueezeNet 1.0 (224x224):
    the three lines; the fp32 Engine's first batch against the CPU's."""
    from onnx_rusty_inference_engine_tpu_torch.benchmarks import accuracy
    from onnx_rusty_inference_engine_tpu_torch.engine import Engine
    from onnx_rusty_inference_engine_tpu_torch.graph import import_model
    from onnx_rusty_inference_engine_tpu_torch.models.squeezenet import (
        build_squeezenet)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    top = accuracy.top1s(ACC_MODEL, ACC_BATCHES, ACC_BATCH, "cuda")
    counts = read_counts()
    n_q = 26 * len(accuracy.METHODS) * ACC_BATCHES
    require(counts["qconv_int8_requant"] == n_q,
            f"accuracy: 26 int8 conv launches per INT8 forward: {counts}")
    rng = np.random.default_rng(7)            # the script's draws
    rng.standard_normal((8, 3, 224, 224))
    x = rng.standard_normal((ACC_BATCH, 3, 224, 224)).astype(np.float32)
    ref = Engine(import_model(build_squeezenet()), device="cpu").run(
        {"data_0": x}).outputs
    ref = next(iter(ref.values())).reshape(ACC_BATCH, -1)
    top2 = np.sort(ref, axis=-1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] < 1e-4 * (ref.max(-1) - ref.min(-1))
    differ = top["fp32"][:ACC_BATCH] != ref.argmax(-1)
    require(not (differ & ~tie).any(), "accuracy: the fp32 top-1 of the "
            "first batch equals the CPU's")
    for line in accuracy.lines(ACC_MODEL, top):
        emit({"phase": "families", "path": "int8_accuracy", **line,
              "card": smi})
    _fam_line("int8_accuracy", t0, smi, model=ACC_MODEL,
              held_out=ACC_BATCHES * ACC_BATCH, launches=counts,
              fp32_first_batch_equal_cpu=int((~differ).sum()),
              near_ties_excused=int((differ & tie).sum()))
    return {"qconv_int8_requant": {
        "launches": counts["qconv_int8_requant"], "per_int8_forward": 26}}


def phase_families_lora(gen, prompts, smi: str) -> dict:
    """The families phase's first path, on phase 6's Generator: multi-LoRA
    GPT-2. Returns its kernels' launches and its seconds."""
    t0 = time.perf_counter()
    res = _fam_lora(gen, prompts, smi)
    torch.cuda.empty_cache()
    return {"lora": res, "seconds": time.perf_counter() - t0}


def phase_families(smi: str, lora: dict) -> dict:
    """The model families of ROADMAP's [1.8] at full width, each decode
    step a captured graph, replayed: multi-LoRA on phase 6's GPT-2 path
    (run before, `phase_families_lora`), the MoE decoder, T5-small and
    Whisper-style ASR through Seq2SeqGenerator, the INT8 accuracy
    benchmark. Returns each kernel's launches on these paths, by path."""
    from onnx_rusty_inference_engine_tpu_torch.models.asr import ASRConfig
    from onnx_rusty_inference_engine_tpu_torch.models.t5 import T5Config

    t0 = time.perf_counter()
    res = {"lora": lora["lora"], "moe": _fam_moe(smi)}
    torch.cuda.empty_cache()
    r = np.random.default_rng(0)
    t5 = T5Config()
    res["t5"] = _fam_seq2seq(
        "t5", t5, r.integers(0, t5.vocab_size, (T5_BATCH, T5_SRC)),
        T5_MAX, T5_NEW, smi, int4=True)
    torch.cuda.empty_cache()
    audio = (r.standard_normal((ASR_BATCH, ASR_SAMPLES)) * 0.1).astype(
        np.float32)
    res["asr"] = _fam_seq2seq("asr", ASRConfig(), audio, ASR_MAX, ASR_NEW,
                              smi, int4=False)
    torch.cuda.empty_cache()
    res["accuracy"] = _fam_accuracy(smi)
    torch.cuda.empty_cache()
    emit({"phase": "families",
          "seconds": time.perf_counter() - t0 + lora["seconds"],
          "lora_seconds": lora["seconds"]})
    by_kernel: dict = {}
    for path, kernels in res.items():
        for name, got in kernels.items():
            by_kernel.setdefault(name, {})[path] = got
    return by_kernel


# --------------------------------------------------------------------------
# decoding beyond greedy and the rest of serving
# --------------------------------------------------------------------------
BEAM_BATCH, BEAM_K, BEAM_NEW = 4, 4, 32
S2S_BEAM_BATCH, S2S_SRC, S2S_NEW = 4, 512, 32
SPEC_K, SPEC_NEW, SPEC_DRAFT_LAYERS = 4, 32, 2
SPEC_SLOTS, SPEC_REQS, SPEC_PLEN, SPEC_ROUNDS = 8, 16, 48, 4
S2S_SLOTS, S2S_REQS, S2S_K = 8, 16, 8
SPEC_SAMPLED = dict(temperature=0.8, seed=5)


def _dec_line(path: str, t0: float, smi: str, **kw) -> None:
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "decoding", "path": path, **kw, "peak_gb": peak / 1e9,
          "seconds": time.perf_counter() - t0, "card": smi})


def _score_rel(got, want) -> float:
    """The largest elementwise |got - want| / |want| of two beams' scores
    (summed log-probs, never 0)."""
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                        / np.abs(np.asarray(want))))


def _dec_beam(cfg, smi: str) -> dict:
    """BeamGenerator on GPT-2 124M with INT4 weights: the host loop, the
    device loop (every step after the first one CUDA graph), beam=1
    against the greedy Generator."""
    from onnx_rusty_inference_engine_tpu_torch.generate import (
        BeamGenerator, Generator)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    B, K, N, P = BEAM_BATCH, BEAM_K, BEAM_NEW, PROMPT
    prompts = _decode_prompts(cfg)[:B]
    kw = dict(batch=B, prompt_len=P, max_len=P + N, int4_weights=True)
    bg = BeamGenerator(cfg, beam=K, **kw)
    n_pre, n_step = _mm_nbits(bg.prefill.graph), _mm_nbits(bg.decode.graph)
    require(n_pre == n_step == 4 * cfg.n_layer + 1,
            f"beam: 49 MatMulNBits per graph: {n_pre}, {n_step}")
    want = n_pre + (N - 1) * n_step
    bg.generate(prompts, 2)                  # captures the prefill and step
    reset_counts()
    (ht, hs), host_s = _wall(lambda: bg.generate(prompts, N))
    host_counts = read_counts()
    bg.device_loop = True
    first = bg.generate(prompts, N)          # the eager block, the capture
    reset_counts()
    (dt, ds), dev_s = _wall(lambda: bg.generate(prompts, N))
    dev_counts = read_counts()
    require(host_counts["qmatmul_int4_planar"] == want
            and dev_counts["qmatmul_int4_planar"] == want,
            f"beam: {n_pre} int4 launches per prefill and {n_step} per step "
            f"({want}): host {host_counts}, device {dev_counts}")
    rel = max(_score_rel(ds, hs), _score_rel(first[1], hs))
    require(np.array_equal(dt, ht) and np.array_equal(first[0], ht)
            and rel <= 1e-5, f"beam: the device loop's beams are the host "
            f"loop's (scores {rel})")
    block_ms = cuda_ms(bg.steps._graphs[("beam", N, None)], 3)
    del bg
    b1 = BeamGenerator(cfg, beam=1, **kw)
    t1, _ = b1.generate(prompts, N)
    del b1
    iso = Generator(cfg, batch=1, prompt_len=P, max_len=P + N,
                    int4_weights=True)
    vs_iso = _served_vs_isolated("beam=1", [list(r) for r in t1], prompts,
                                 iso)
    del iso
    _dec_line("beam", t0, smi, model="gpt2 124M (SMALL, seed 0), int4 "
              "planar, fp32 KV", batch=B, beam=K, prompt=P, new_tokens=N,
              launches_host_loop=host_counts, launches_device_loop=dev_counts,
              int4_per_prefill=n_pre, int4_per_step=n_step,
              device_equals_host=True, device_vs_host_score_rel=rel,
              tokens_per_s_host_loop=B * N / host_s,
              tokens_per_s_device_loop=B * N / dev_s,
              block_replay_ms=block_ms, block_steps=N - 1,
              beam1_vs_greedy=vs_iso, scores_row0=float(hs[0]),
              tokens_row0=ht[0, :16].tolist())
    return {"beam_host_loop": host_counts["qmatmul_int4_planar"],
            "beam_device_loop": dev_counts["qmatmul_int4_planar"],
            "per_prefill": n_pre, "per_step": n_step}


def _dec_seq2seq_beam(t5cfg, smi: str) -> None:
    """Seq2SeqBeamGenerator on T5-small: the host loop and the device
    loop agree."""
    from onnx_rusty_inference_engine_tpu_torch.generate import (
        Seq2SeqBeamGenerator)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    B, N = S2S_BEAM_BATCH, S2S_NEW
    src = np.random.default_rng(1).integers(0, t5cfg.vocab_size,
                                            (B, S2S_SRC))
    bg = Seq2SeqBeamGenerator(t5cfg, batch=B, beam=BEAM_K, src_len=S2S_SRC,
                              max_len=N)
    bg.generate(src, 2)                       # captures the encoder, step
    (ht, hs), host_s = _wall(lambda: bg.generate(src, N))
    bg.device_loop = True
    bg.generate(src, N)
    (dt, ds), dev_s = _wall(lambda: bg.generate(src, N))
    rel = _score_rel(ds, hs)
    require(np.array_equal(dt, ht) and rel <= 1e-5,
            f"t5 beam: the device loop's beams are the host loop's ({rel})")
    block_ms = cuda_ms(bg.steps._graphs[("beam", N, None)], 3)
    del bg
    _dec_line("seq2seq_beam", t0, smi, model="t5-small (T5Config(), seed "
              "0), fp32", batch=B, beam=BEAM_K, src_len=S2S_SRC,
              new_tokens=N, device_equals_host=True,
              device_vs_host_score_rel=rel,
              tokens_per_s_host_loop=B * N / host_s,
              tokens_per_s_device_loop=B * N / dev_s,
              block_replay_ms=block_ms, tokens_row0=ht[0, :16].tolist())


def _dec_speculative(cfg, smi: str) -> None:
    """SpeculativeGenerator on `cfg` (GPT-2 124M's widths at
    GPT2_SIDE_LAYERS layers) in fp32, the draft the target and a 2-layer
    draft, against the target's greedy Generator."""
    from onnx_rusty_inference_engine_tpu_torch.generate import (
        Generator, SpeculativeGenerator)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    B, P, N, k = DEC_BATCH, PROMPT, SPEC_NEW, SPEC_K
    prompts = _decode_prompts(cfg)
    ML = P + N + k
    greedy = Generator(cfg, batch=B, prompt_len=P, max_len=ML)
    greedy.generate(prompts, 2)
    (gt, _), greedy_s = _wall(lambda: greedy.generate(prompts, N))
    del greedy
    iso = None          # the isolated greedy Generator, where a row differs
    runs = {}
    for name, dcfg, dseed in (
            ("draft_is_target", None, 0),
            ("draft_2_layers",
             dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS), 1)):
        sg = SpeculativeGenerator(cfg, dcfg, batch=B, prompt_len=P,
                                  max_len=ML, k=k, draft_seed=dseed)
        sg.generate(prompts, k + 1)                # captures every call
        sg.accepted_total = sg.proposed_total = 0
        (st, _), wall = _wall(lambda: sg.generate(prompts, N))
        acc = sg.acceptance_rate
        del sg
        if dcfg is None:
            require(acc == 1.0, f"speculative: the target as its own "
                    f"draft accepts every proposal ({acc})")
        differ = [r for r in range(B) if not np.array_equal(st[r], gt[r])]
        if differ and iso is None:
            iso = Generator(cfg, batch=1, prompt_len=P, max_len=ML)
        vs_iso = _served_vs_isolated(name, [list(st[r]) for r in differ],
                                     prompts[differ], iso)
        runs[name] = {"acceptance_rate": acc, "tokens_per_s": B * N / wall,
                      "rows_equal_greedy": B - len(differ),
                      "differing_rows_vs_isolated": vs_iso}
    del iso
    _dec_line("speculative", t0, smi, model=f"{GPT2_SIDE}, "
              "fp32", batch=B, prompt=P, new_tokens=N, k=k,
              draft_layers=SPEC_DRAFT_LAYERS, runs=runs,
              greedy_tokens_per_s=B * N / greedy_s)


def _spec_prompts(cfg) -> np.ndarray:
    """SPEC_REQS prompts of SPEC_PLEN tokens, each a random motif of 3-8
    tokens repeated: text that prompt lookup can continue."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(SPEC_REQS):
        motif = rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 9)),))
        out.append(np.tile(motif, -(-SPEC_PLEN // motif.size))[:SPEC_PLEN])
    return np.stack(out)


def _dec_spec_server(cfg, smi: str) -> None:
    """SpeculativeServer on `cfg` (GPT-2 124M's widths at GPT2_SIDE_LAYERS
    layers) in fp32: a 2-layer draft and prompt lookup, each in host
    rounds and in blocks of SPEC_ROUNDS rounds."""
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.serving import (
        SpeculativeServer)

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    prompts = _spec_prompts(cfg)
    N, k, PL = SPEC_NEW, SPEC_K, PROMPT
    ML = PL + N + k
    draft = dataclasses.replace(cfg, n_layer=SPEC_DRAFT_LAYERS)
    runs, outs = {}, {}
    for name, kw in (("draft_host_rounds", {}),
                     ("draft_multi_step", {"multi_step": SPEC_ROUNDS}),
                     ("ngram_host_rounds", {"ngram": 2}),
                     ("ngram_multi_step", {"ngram": 2,
                                           "multi_step": SPEC_ROUNDS})):
        srv = SpeculativeServer(cfg, None if kw.get("ngram") else draft,
                                slots=SPEC_SLOTS, prompt_len=PL, max_len=ML,
                                k=k, draft_seed=1, autostart=False, **kw)
        try:
            warm = srv.submit(prompts[0][:8], 6)   # captures every graph
            srv.start()
            warm.result(timeout=600)
            srv.steps = srv.tokens_out = srv.requests_done = 0
            srv._occupancy_sum = srv.accepted_total = srv.proposed_total = 0
            srv._latencies.clear()
            futs = [srv.submit(p, N) for p in prompts]
            outs[name], wall = _wall(lambda: [f.result(timeout=600)
                                              for f in futs])
            st = srv.stats()
            caches = list(srv._t_cache.values()) + list(
                srv._d_cache.values())
            require(all(bool(torch.isfinite(c).all()) for c in caches),
                    f"{name}: every cache row finite, parked lanes' too")
            seed_contract = None
            if name == "draft_multi_step":
                # a sampled request alone, then beside greedy ones in
                # every other slot
                alone = srv.submit(prompts[1], N, **SPEC_SAMPLED).result(
                    timeout=600)
                fs = [srv.submit(p, N) for p in prompts[2:SPEC_SLOTS + 1]]
                at = len(fs) // 2
                fs.insert(at, srv.submit(prompts[1], N, **SPEC_SAMPLED))
                beside = [f.result(timeout=600) for f in fs][at]
                require(beside == alone, "draft_multi_step: a sampled "
                        "request's tokens do not depend on its neighbours")
                seed_contract = {"sampling": SPEC_SAMPLED,
                                 "tokens_row": alone[:16]}
        finally:
            srv.stop()
        del srv
        torch.cuda.empty_cache()
        runs[name] = {"served_tokens_per_s": SPEC_REQS * N / wall,
                      "acceptance_rate": st["acceptance_rate"],
                      "dispatches": st["decode_steps"],
                      "tokens_per_dispatch": st["tokens_per_step"],
                      "p50_latency_s": st["p50_latency_s"],
                      "seed_contract": seed_contract}
    # served == isolated greedy: the first requests of the first run
    # teacher-forced, and every request another run serves differently
    iso = Generator(cfg, batch=1, prompt_len=SPEC_PLEN, max_len=ML)
    ref = outs["draft_host_rounds"]
    vs = {"draft_host_rounds": _served_vs_isolated(
        "draft_host_rounds", ref[:ISOLATED_CHECK],
        prompts[:ISOLATED_CHECK], iso)}
    for name, got in outs.items():
        differ = [r for r in range(SPEC_REQS) if got[r] != ref[r]]
        runs[name]["requests_equal_first_run"] = SPEC_REQS - len(differ)
        if differ:
            vs[name] = _served_vs_isolated(name, [got[r] for r in differ],
                                           prompts[differ], iso)
    del iso
    _dec_line("spec_server", t0, smi, model=f"{GPT2_SIDE}, "
              "fp32", slots=SPEC_SLOTS, requests=SPEC_REQS,
              prompt=SPEC_PLEN, new_tokens=N, k=k,
              draft_layers=SPEC_DRAFT_LAYERS, ngram=2,
              rounds_per_block=SPEC_ROUNDS, runs=runs, served_vs_isolated=vs)


def _dec_seq2seq_server(t5cfg, smi: str) -> None:
    """Seq2SeqServer on T5-small at multi_step 0 and S2S_K, with an
    encoder cache and one repeated source, against an isolated
    Seq2SeqGenerator teacher-forced on the served tokens."""
    from onnx_rusty_inference_engine_tpu_torch.generate import (
        Seq2SeqGenerator)
    from onnx_rusty_inference_engine_tpu_torch.serving import Seq2SeqServer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(2)
    srcs = rng.integers(0, t5cfg.vocab_size, (S2S_REQS, S2S_SRC))
    srcs[5] = srcs[3]             # a hit: sources 1-4 are in the LRU of 4
    N = S2S_NEW
    runs, outs = {}, {}
    for K in (0, S2S_K):
        srv = Seq2SeqServer(t5cfg, slots=S2S_SLOTS, src_len=S2S_SRC,
                            max_len=N, encoder_cache=4, multi_step=K,
                            autostart=False)
        try:
            warm = srv.submit(rng.integers(0, t5cfg.vocab_size, (S2S_SRC,)),
                              K + 2)
            srv.start()
            warm.result(timeout=600)
            srv.encoder_cache_hits = 0
            srv.steps = srv.tokens_out = srv._occupancy_sum = 0
            srv._latencies.clear()
            futs = [srv.submit(s, N) for s in srcs]
            outs[K], wall = _wall(lambda: [f.result(timeout=600)
                                           for f in futs])
            st = srv.stats()
        finally:
            srv.stop()
        del srv
        require(st["encoder_cache_hits"] == 1,
                f"seq2seq server: one encoder-cache hit ({st})")
        runs[K] = {"served_tokens_per_s": S2S_REQS * N / wall,
                   "dispatches": st["decode_steps"],
                   "encoder_cache_hits": st["encoder_cache_hits"],
                   "p50_latency_s": st["p50_latency_s"]}
    iso = Seq2SeqGenerator(t5cfg, batch=S2S_REQS, src_len=S2S_SRC,
                           max_len=N)
    picks, ties = 0, []
    for K, got in outs.items():
        toks = np.asarray(got)
        _, logits = _teacher_forced(iso, srcs, toks, S2S_REQS)
        for t, lg in enumerate(logits):
            for r in range(S2S_REQS):
                picks += 1
                if int(lg[r].argmax()) != int(toks[r, t]):
                    top2 = np.sort(lg[r])[-2:]
                    margin = float((top2[1] - top2[0])
                                   / (lg[r].max() - lg[r].min()))
                    ties.append({"multi_step": K, "request": r, "step": t,
                                 "rel_margin": margin})
                    require(margin < NEAR_TIE, f"seq2seq server "
                            f"(multi_step {K}): request {r}'s token {t} is "
                            f"not its isolated pick (margin {margin})")
    del iso
    _dec_line("seq2seq_server", t0, smi, model="t5-small (T5Config(), seed "
              "0), fp32", slots=S2S_SLOTS, requests=S2S_REQS,
              src_len=S2S_SRC, new_tokens=N, encoder_cache=4,
              runs={f"multi_step_{K}": r for K, r in runs.items()},
              served_vs_isolated={"picks": picks, "near_ties": ties},
              multi_step_equals_single=outs[0] == outs[S2S_K])


def phase_decoding(smi: str) -> dict:
    """Decoding beyond greedy and the rest of serving (ROADMAP [1.9] and
    [1.10b]): beam search (host loop and device loop), Seq2Seq beam
    search, speculative decoding, SpeculativeServer and Seq2SeqServer.
    Returns the int4 kernel's launches on the beam path."""
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
    from onnx_rusty_inference_engine_tpu_torch.models.t5 import T5Config

    t0 = time.perf_counter()
    cfg, t5cfg = GPT2Config(), T5Config()
    beam = _dec_beam(cfg, smi)
    torch.cuda.empty_cache()
    _dec_seq2seq_beam(t5cfg, smi)
    torch.cuda.empty_cache()
    side = GPT2Config(n_layer=GPT2_SIDE_LAYERS)
    _dec_speculative(side, smi)
    torch.cuda.empty_cache()
    _dec_spec_server(side, smi)
    torch.cuda.empty_cache()
    _dec_seq2seq_server(t5cfg, smi)
    torch.cuda.empty_cache()
    emit({"phase": "decoding", "seconds": time.perf_counter() - t0})
    return {"qmatmul_int4_planar": beam}


# --------------------------------------------------------------------------
# int8_whole: 3-D QLinearConv / ConvInteger (R3D-18), zero points computed
# at run time (ONNX Runtime's dynamically quantized SqueezeNet), the native
# C++ parser, a bf16 graph input
# --------------------------------------------------------------------------
WHOLE_BATCH = 16        # R3D-18 clips per forward (3 x 16 x 112 x 112)
WHOLE_CLIPS = 2         # clips (images) re-run through the plain versions
WHOLE_ITERS = 3         # replayed forwards timed per Engine
WHOLE_KERNEL_ITERS = 3  # launches per captured graph in a kernel timing
# the depthwise 3x3x3 of channel-separated nets, at R3D-18 layer1's
# activation: 64 channels, 16 x 56 x 56
DW3D_SHAPE = (WHOLE_BATCH, 64, 16, 56, 56)
# R3D-18 INT8 logits against fp32, as the vision phase's INT8 bounds
WHOLE_INT8_BOUND = "top-1 agreement >= 0.75 or max |d| / max |ref| < 0.1"


def _same_proto(a, b) -> bool:
    """Two parses of the port's onnx_io equal field by field: arrays by
    dtype, shape and values, bf16 tensors by their bits. A ValueInfo with
    no dims: shape None from the C++ parser, [] from the Python codec (the
    JAX package's two parsers differ so too; the importer reads both as
    ())."""
    import dataclasses

    from onnx_rusty_inference_engine_tpu_torch import onnx_io

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, onnx_io.ValueInfo) and isinstance(b, onnx_io.ValueInfo):
        a = dataclasses.replace(a, shape=a.shape or None)
        b = dataclasses.replace(b, shape=b.shape or None)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(
            _same_proto(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_proto(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_proto(x, y) for x, y in zip(a, b)))
    return type(a) is type(b) and a == b


def _whole_native(smi: str) -> dict:
    """The native C++ parser against the pure-Python codec on the bytes of
    SqueezeNet 1.0, BERT-base and GPT-2 124M (random weights, seed 0):
    equal field by field, with both parse times on the card's host. The
    library must build (a build failure fails the phase)."""
    import tempfile

    from onnx_rusty_inference_engine_tpu_torch import native_loader, onnx_io
    from onnx_rusty_inference_engine_tpu_torch.models import (bert, gpt2,
                                                              squeezenet)

    t0 = time.perf_counter()
    lib = native_loader.get_lib()  # built beside the kernels (phase 2)
    require(lib is not None, "native: the C++ parser builds and loads")
    models = {
        "squeezenet1.0": lambda: squeezenet.build_squeezenet(),
        "bert-base": lambda: bert.build_bert(bert.BASE, batch=BERT_BATCH,
                                             seq_len=BERT_SEQ, seed=0),
        "gpt2-124M": lambda: gpt2.build_gpt2(gpt2.SMALL, batch=DEC_BATCH,
                                             seq_len=PROMPT),
    }
    out = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        for name, build in models.items():
            path = os.path.join(d, f"{name}.onnx")
            onnx_io.save_model(path, build())
            t1 = time.perf_counter()
            native = native_loader.load_model_native(path)
            native_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            python = onnx_io.load_model(path)
            python_s = time.perf_counter() - t1
            require(native is not None and _same_proto(native, python),
                    f"native: {name}'s native parse equals the Python "
                    f"codec's field by field")
            out[name] = {"bytes": os.path.getsize(path),
                         "nodes": len(native.graph.nodes),
                         "initializers": len(native.graph.initializers),
                         "native_parse_s": native_s,
                         "python_parse_s": python_s,
                         "equal_field_by_field": True}
            del native, python
    line = {"phase": "int8_whole", "path": "native",
            "library": native_loader.library_path(), "models": out, "seconds": time.perf_counter() - t0, "card": smi}
    emit(line)
    return line


def _conv3d_library_ms(name, args, kw):
    """F.conv3d in fp32 through cuDNN (TF32 off) on the call's operands as
    floats: the one PyTorch call of a 3-D conv (PyTorch has no int8 3-D
    conv), for context only; None for other calls."""
    import torch.nn.functional as F

    x, w = args[0], args[1]
    if x.dim() != 5 or name.startswith("qmatmul"):
        return None
    xf = x.float().contiguous(memory_format=torch.channels_last_3d)
    wf = w.float()
    pads = kw.get("padding", ((0, 0),) * 3)
    if any(lo != hi for lo, hi in pads):
        return None
    groups = x.shape[1] // w.shape[1]
    return graph_ms(lambda: F.conv3d(
        xf, wf, stride=tuple(kw.get("stride", (1, 1, 1))),
        padding=tuple(lo for lo, _ in pads),
        dilation=tuple(kw.get("dilation") or (1, 1, 1)), groups=groups),
        WHOLE_KERNEL_ITERS, 2)


def _call_plan(name, args, kw) -> str:
    """How the kernel ran a recorded conv call: the group-1 conv's A
    producer (`conv_plan`), the grouped conv's form (`grouped_plan`)."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_grouped_int8 as g8, qconv_int8 as c8)

    x, w = args[0], args[1]
    geo = (kw.get("stride") or (1,) * (x.dim() - 2),
           kw.get("padding") or ((0, 0),) * (x.dim() - 2))
    device_zp = any(isinstance(kw.get(z), torch.Tensor)
                    for z in ("pad_value", "y_zp"))
    if name.startswith("qconv_grouped"):
        return g8.grouped_plan(x.shape, w.shape, *geo, g8.input_align(x),
                               kw.get("dilation"),
                               name == "qconv_grouped_int8", device_zp)["form"]
    return c8.conv_plan(x.shape, w.shape, *geo, kw.get("dilation"),
                        "int32" if name == "qconv_int8" else "requant")[0]


def _stem_geometry(name: str, args, kw):
    """A recorded group-1 conv call's space-to-depth rewrite
    (`qconv_int8.s2d_conv`), or None: not a stem, or not that kernel."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_int8 as c8)

    if name not in ("qconv_int8_requant", "qconv_int8"):
        return None
    x, w = args[0], args[1]
    sp = x.dim() - 2
    return c8.s2d_conv(x.shape, w.shape, kw.get("stride") or (1,) * sp,
                       kw.get("padding") or ((0, 0),) * sp,
                       kw.get("dilation"))


def _stem_layout_ms(path: str, x, geo: dict, pad_value) -> float:
    """The stem's layout kernel (`qconv_int8.space_to_depth`) on the
    card's own x, bit-equal to its plain version; its time alone (a
    replayed CUDA graph)."""
    from onnx_rusty_inference_engine_tpu_torch.ops.kernels import (
        qconv_int8 as c8)

    def layout():
        return c8.space_to_depth(x, geo, pad_value)

    require(torch.equal(layout(), c8.space_to_depth_plain(x, geo, pad_value)),
            f"int8_whole {path}: the space-to-depth layout kernel == plain")
    return graph_ms(layout, WHOLE_KERNEL_ITERS, 2)


def _whole_calls(path: str, calls: list, counts: dict, forwards: int,
                 library, no_library: str) -> dict:
    """Each recorded kernel call of one forward bit-equal to its plain
    version on the card's own operands, on the first WHOLE_CLIPS clips
    (images); its kernel time (the whole batch, from a replayed CUDA
    graph; where x is not channels-last, on a channels-last copy, the
    wrapper's copy apart as `layout_copy_ms`; a stem's space-to-depth
    layout pass likewise apart, the kernel held to its plain version),
    its plain time (those
    clips), `library(name, args, kw)`'s time and its bound; summed per
    kernel over the forward, and each conv call
    listed under its kernel's `calls` (x and w shapes, stride, the plan's
    producer or form, ms, bound_ms, bound_by). The counts of the main
    path's run must be the calls x `forwards`."""
    tot = {}
    for name, args, kw, out in calls:
        kern, plain = _wrapper_and_plain(name)
        pkw = {k: v for k, v in kw.items() if k != "packed"}
        head = tuple(a[:WHOLE_CLIPS] if i == 0 else a
                     for i, a in enumerate(args))
        want, plain_ms = _timed(lambda: plain(*head, **pkw))
        got = out[:WHOLE_CLIPS]
        err = int((got.int() - want.int()).abs().max())
        require(torch.equal(got, want), f"int8_whole {path}: {name} == "
                f"plain on the card's operands (max |diff| {err})")
        ms = graph_ms(lambda: kern(*args, **kw), WHOLE_KERNEL_ITERS, 2)
        # an input that is not channels-last (a graph input) is copied by the
        # wrapper: the kernel alone is timed on a channels-last copy; a
        # stem's input is laid out as its space-to-depth rewrite, a pass
        # timed alone (and held to its plain version) and taken out of ms
        copy_ms = 0.0
        x = args[0]
        geo = _stem_geometry(name, args, kw)
        if geo is not None:
            copy_ms = _stem_layout_ms(path, x, geo, kw.get("pad_value", 0))
            ms -= copy_ms
        elif x.dim() == 5 and not x.permute(0, 2, 3, 4, 1).is_contiguous():
            xc = (x.contiguous(memory_format=torch.channels_last_3d),)
            kernel_ms = graph_ms(lambda: kern(*xc, *args[1:], **kw),
                                 WHOLE_KERNEL_ITERS, 2)
            copy_ms, ms = ms - kernel_ms, kernel_ms
        lib_ms = library(name, args, kw)
        ops, nbytes = _qop_kernel_work(name, args, kw, out)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes,
                                                     INT8_OPS_PER_S)
        v = tot.setdefault(_QOP_KERNEL[name], dict.fromkeys(
            ("per_forward", "ms", "plain_ms", "bound_ms", "ops_ms",
             "bytes_ms", "library_ms", "layout_copy_ms"), 0.0))
        v["per_forward"] += 1
        v["ms"] += ms
        v["layout_copy_ms"] += copy_ms
        v["plain_ms"] += plain_ms
        v["bound_ms"] += bound_ms
        v["ops_ms"] += ops_ms
        v["bytes_ms"] += bytes_ms
        v["library_ms"] = (None if lib_ms is None or v["library_ms"] is None
                           else v["library_ms"] + lib_ms)
        if name.startswith("qconv"):
            v.setdefault("calls", []).append({
                "x": list(args[0].shape), "w": list(args[1].shape),
                "stride": list(kw.get("stride") or ()),
                "plan": _call_plan(name, args, kw), "ms": ms,
                "layout_copy_ms": copy_ms, "bound_ms": bound_ms,
                "bound_by": bound_by})
    require({k: int(v["per_forward"]) * forwards for k, v in tot.items()}
            == {k: n for k, n in counts.items() if n},
            f"int8_whole {path}: the calls of one forward x {forwards} "
            f"forwards against the main path's launches {counts}")
    for kernel, v in tot.items():
        by_plan = {}
        for c in v.get("calls", ()):
            b = by_plan.setdefault(c["plan"], {"calls": 0, "ms": 0.0,
                                               "bound_ms": 0.0})
            b["calls"] += 1
            b["ms"] += c["ms"]
            b["bound_ms"] += c["bound_ms"]
        if by_plan:
            v["by_plan"] = by_plan
        v["launches"] = counts[kernel]
        v["bound_by"] = ("operations" if v.pop("ops_ms") >= v.pop("bytes_ms")
                         else "bytes")
        v["plain_per"] = (f"the first {WHOLE_CLIPS} clips (images) of the "
                          f"batch")
        v["library"] = ("F.conv3d fp32 (cuDNN, TF32 off) on the operands as "
                        "floats: not int8, context only"
                        if v["library_ms"] is not None else no_library)
    return tot


def _eager_calls(eng, dev_feed) -> list:
    """The kernel wrapper calls of one eager forward of `eng`."""
    calls = []
    with torch.no_grad(), _recorded_kernel_calls(calls):
        eng.forward(dev_feed)
    torch.cuda.synchronize()
    return calls


def _whole_r3d(smi: str) -> dict:
    """R3D-18 (torchvision's r3d_18, Kinetics-400, published widths: 20
    convs; BatchNorm folded; random weights from seed 0;
    tests/torch_port_video.py) on b16 clips of 3 x 16 x 112 x 112 through
    the Engine: fp32 (F.conv3d), then calibrate (minmax) on x[:2],
    quantize_graph and the INT8 Engine. Counts set to 0 just before, read
    just after: 20 qconv_int8_requant launches per forward, every one the
    3-D form, the 13 stride-1 3x3x3 convs and the stem (as its space-to-
    depth rewrite, the s2d form) on the staged-halo producer and the other
    6 on the gather, and the fc's qmatmul_int8. Each
    QLinearConv's output bit-equal to its plain version on the card's
    operands for the first 2 clips; clips/s of both from CUDA events over
    replayed forwards; the INT8 logits against fp32."""
    import onnx_rusty_inference_engine_tpu_torch as P

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_video import R3D_CLIP, R3D_INPUT, R3D_LOGITS, build_r3d18

    t0 = time.perf_counter()
    graph = P.import_model(build_r3d18())
    x = np.random.default_rng(0).standard_normal(
        (WHOLE_BATCH, *R3D_CLIP)).astype(np.float32)
    feed = {R3D_INPUT: x}
    dev = {R3D_INPUT: torch.as_tensor(x, device="cuda")}
    eng = P.Engine(graph)
    y32 = eng(feed)[R3D_LOGITS].float()
    fp32_ms = cuda_ms(lambda: eng(dev), WHOLE_ITERS, 1)
    ranges = P.calibrate(graph, [{R3D_INPUT: x[:2]}])
    qgraph = P.quantize_graph(graph, ranges=ranges)
    n_qconv = sum(n.op_type == "QLinearConv" for n in qgraph.nodes)
    reset_counts()
    eng8 = P.Engine(qgraph)
    y8 = eng8(feed)[R3D_LOGITS].float()
    int8_ms = cuda_ms(lambda: eng8(dev), WHOLE_ITERS, 1)
    counts = {k: v for k, v in read_counts().items() if v}
    splits = read_splits("qconv_int8_requant")
    forwards = 2 + WHOLE_ITERS
    per_forward = {"qconv_int8_requant": 20, "qmatmul_int8": 1}
    require(n_qconv == 20 and counts == {k: n * forwards
                                         for k, n in per_forward.items()},
            f"r3d18: {per_forward} launches per INT8 forward over "
            f"{forwards} forwards: {counts}")
    require(splits["forms"]["3d"] == 20 * forwards
            and splits["forms"]["s2d"] == forwards
            and splits["producers"] == {"tma": 0, "gather": 6 * forwards,
                                        "halo": 14 * forwards},
            f"r3d18: every conv launch the 3-D form, the 13 stride-1 3x3x3 "
            f"and the stem (as its space-to-depth rewrite) on the "
            f"staged-halo producer, the strided convs and the shortcuts on "
            f"the gather: {splits}")
    require(bool(torch.isfinite(y8).all())
            and tuple(y8.shape) == (WHOLE_BATCH, 400),
            f"r3d18: INT8 logits {tuple(y8.shape)} finite")
    main_s = time.perf_counter() - t0
    calls = _eager_calls(eng8, dev)
    rows = _whole_calls("r3d18", calls, counts, forwards,
                        _conv3d_library_ms,
                        "none: PyTorch has no int8 3-D conv")
    top1 = float((y8.argmax(1) == y32.argmax(1)).float().mean())
    rel = float((y8 - y32).abs().max() / y32.abs().max())
    line = {"phase": "int8_whole", "path": "r3d18",
            "model": "r3d_18 (torchvision video ResNet, Kinetics-400 head, "
                     "published widths, seed 0)",
            "clip": list(R3D_CLIP), "batch": WHOLE_BATCH,
            "clips_per_s": {"fp32": WHOLE_BATCH / fp32_ms * 1e3,
                            "int8": WHOLE_BATCH / int8_ms * 1e3},
            "forward_ms": {"fp32": fp32_ms, "int8": int8_ms},
            "launches": counts, "launches_per_forward": per_forward,
            "splits": splits, "kernel_calls_equal_plain": len(calls),
            "plain_clips": WHOLE_CLIPS,
            "int8_vs_fp32": {"top1_agreement": top1,
                             "max_abs_over_max_ref": rel,
                             "bound": WHOLE_INT8_BOUND},
            "main_path_s": main_s, "kernels": rows,
            "seconds": time.perf_counter() - t0, "card": smi}
    emit(line)
    require(top1 >= 0.75 or rel < 0.1,
            f"r3d18: INT8 against fp32 ({WHOLE_INT8_BOUND}): top-1 {top1}, "
            f"rel {rel}")
    return rows


def _one_node_graph(op, inputs, consts, feeds, attrs=None, domain=""):
    """A graph of one `op` node over `inputs` (ONNX order), `consts` as its
    constants (weights) and `feeds` name -> (shape, dtype) as its inputs."""
    from onnx_rusty_inference_engine_tpu_torch.graph import (Graph,
                                                             InputSpec, Node)

    return Graph(name=op.lower(), nodes=[Node(op, list(inputs), ["y"], op,
                                              dict(attrs or {}), domain)],
                 constants=dict(consts),
                 inputs=[InputSpec(k, shape, np.dtype(dt))
                         for k, (shape, dt) in feeds.items()],
                 outputs=["y"], opset=13,
                 weight_names=[k for k, v in consts.items()
                               if np.ndim(v) >= 1])


def _whole_depthwise3d(smi: str) -> dict:
    """The channel-separated nets' depthwise 3x3x3 (ir-CSN, X3D) as one
    QLinearConv node at R3D-18 layer1's activation (b16, 64 channels,
    group 64, 16 x 56 x 56, pad 1; int8 x with zero point 3, per-channel
    w_s), on the grouped kernel's tile3d form; and a 3-D ConvInteger at the
    same shape (uint8 x with zero point 131, a per-channel w zero point),
    its int32 sums on the general form. Counts set to 0 just before, read
    just after; every kernel
    call bit-equal to its plain version on the card's operands; the
    ConvInteger's output exact against the CPU's for the first 2 clips."""
    import onnx_rusty_inference_engine_tpu_torch as P

    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    B, C = DW3D_SHAPE[:2]
    x = rng.integers(-128, 128, DW3D_SHAPE).astype(np.int8)
    w = rng.integers(-127, 128, (C, 1, 3, 3, 3)).astype(np.int8)
    attrs = {"kernel_shape": [3, 3, 3], "pads": [1] * 6, "group": C}
    consts = {"x_s": np.float32(0.05), "x_zp": np.int8(3), "w": w,
              "w_s": (np.abs(rng.standard_normal(C)) * 0.01 + 2e-3
                      ).astype(np.float32),
              "w_zp": np.zeros(C, np.int8), "y_s": np.float32(0.2),
              "y_zp": np.int8(-4),
              "b": rng.integers(-2000, 2000, C).astype(np.int32)}
    qg = _one_node_graph("QLinearConv", ["x", "x_s", "x_zp", "w", "w_s",
                                         "w_zp", "y_s", "y_zp", "b"],
                         consts, {"x": (DW3D_SHAPE, np.int8)}, attrs)
    xu = rng.integers(0, 256, DW3D_SHAPE).astype(np.uint8)
    ci = _one_node_graph("ConvInteger", ["x", "w", "x_zp", "w_zp"],
                         {"w": w, "x_zp": np.uint8(131),
                          "w_zp": rng.integers(-3, 4, C).astype(np.int8)},
                         {"x": (DW3D_SHAPE, np.uint8)}, attrs)
    out, rows = {}, {}
    for path, g, xin, per_forward, form in (
            ("depthwise3d", qg, x, 1, "tile3d"),
            ("convinteger3d", ci, xu, 2, "general")):
        dev = {"x": torch.as_tensor(xin, device="cuda")}
        reset_counts()
        eng = P.Engine(g)
        y = eng(dev)["y"]
        ms = cuda_ms(lambda: eng(dev), WHOLE_ITERS, 1)
        counts = {k: v for k, v in read_counts().items() if v}
        splits = read_splits("qconv_grouped_int8_requant")
        forwards = 2 + WHOLE_ITERS
        require(counts == {"qconv_grouped_int8_requant":
                           per_forward * forwards}
                and splits["forms"]["3d"] == per_forward * forwards
                and splits["schedules"][form] == per_forward * forwards,
                f"{path}: {per_forward} 3-D grouped launches a forward on "
                f"the {form} form: {counts} {splits}")
        calls = _eager_calls(eng, dev)
        rows[path] = _whole_calls(path, calls, counts, forwards,
                                  _conv3d_library_ms,
                                  "none: PyTorch has no int8 grouped conv")
        line = {"ms": ms, "launches": counts, "splits": splits,
                "kernel_calls_equal_plain": len(calls)}
        if path == "convinteger3d":
            cpu = P.Engine(g, device="cpu").run(
                {"x": xin[:WHOLE_CLIPS]}).outputs["y"]
            require(np.array_equal(y[:WHOLE_CLIPS].cpu().numpy(), cpu),
                    "convinteger3d: the card's int32 == the CPU's")
            line["equal_cpu_clips"] = WHOLE_CLIPS
        out[path] = line
    emit({"phase": "int8_whole", "path": "depthwise3d",
          "shape": list(DW3D_SHAPE), "group": C, "nodes": out,
          "kernels": rows, "seconds": time.perf_counter() - t0, "card": smi})
    return rows["depthwise3d"]


def _dql_zero_point(x: torch.Tensor) -> int:
    """DynamicQuantizeLinear's zero point of x (its emitter's arithmetic)."""
    x_min = torch.clamp_max(x.amin(), 0.0)
    x_max = torch.clamp_min(x.amax(), 0.0)
    scale = (x_max - x_min) * float(torch.tensor(1.0 / 255.0))
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return int(torch.clamp(torch.round(0.0 - x_min / scale), 0, 255))


def _whole_squeezenet_dynamic(smi: str) -> dict:
    """SqueezeNet 1.0 (224x224, b256, seed 0) in ONNX Runtime's
    quantize_dynamic form (tests/torch_port_dynamic.py: each Conv a
    DynamicQuantizeLinear -> ConvInteger -> Cast -> Mul -> Add) through
    the Engine. Counts set to 0 just before, read just after: 26
    ConvInteger launches per forward on the int32 epilogue, every one
    reading its pad value (the x zero point DynamicQuantizeLinear computes)
    from device memory, SQUEEZENET_DYNAMIC_PRODUCERS by A producer, conv1
    as its space-to-depth rewrite (the s2d form) once a forward. Each
    node's int32 bit-equal to its plain version on the card's operands
    (first 2 images); the captured graph replayed on two inputs whose zero
    points differ, each output equal to its own eager run; images/s."""
    import onnx_rusty_inference_engine_tpu_torch as P

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_port_dynamic import dynamic_bytes, reparsed

    t0 = time.perf_counter()
    graph = reparsed(dynamic_bytes(P.import_model(P.build_squeezenet())))
    logits = graph.outputs[0]
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((BATCH, 3, 224, 224)).astype(np.float32),
          (rng.standard_normal((BATCH, 3, 224, 224)) * 0.5 + 1.5).astype(
              np.float32)]
    devs = [{"data_0": torch.as_tensor(x, device="cuda")} for x in xs]
    zps = [_dql_zero_point(d["data_0"]) for d in devs]
    require(zps[0] != zps[1], f"squeezenet_dynamic: the two inputs' zero "
            f"points differ: {zps}")
    reset_counts()
    eng = P.Engine(graph)
    first = eng(devs[0])[logits]
    ms = cuda_ms(lambda: eng(devs[0]), WHOLE_ITERS, 1)
    replayed = [eng(d)[logits] for d in devs]
    counts = {k: v for k, v in read_counts().items() if v}
    splits = read_splits("qconv_int8_requant")
    forwards = 2 + WHOLE_ITERS + 2
    n = 26 * forwards
    require(counts == {"qconv_int8_requant": n}
            and splits["epilogues"]["int32"] == n
            and splits["forms"]["device_zero_point"] == n
            and splits["forms"]["uint8_x"] == n
            and splits["forms"]["s2d"] == forwards
            and splits["producers"] == {
                k: v * forwards
                for k, v in SQUEEZENET_DYNAMIC_PRODUCERS.items()},
            f"squeezenet_dynamic: 26 ConvInteger launches a forward, each on "
            f"the int32 epilogue with its zero point in device memory, "
            f"{SQUEEZENET_DYNAMIC_PRODUCERS} a forward by A producer: "
            f"{counts} {splits}")
    require(len(eng._graphs) == 1, "squeezenet_dynamic: one captured graph")
    with torch.no_grad():
        eager = [eng.forward(d)[logits] for d in devs]
    for i in range(2):
        require(torch.equal(replayed[i], eager[i]),
                f"squeezenet_dynamic: the replay on input {i} (zero point "
                f"{zps[i]}) equals its eager run")
    require(torch.equal(first, eager[0]) and not torch.equal(eager[0],
                                                             eager[1]),
            "squeezenet_dynamic: first call == eager; the inputs differ")
    require(bool(torch.isfinite(first).all()),
            "squeezenet_dynamic: finite logits")
    calls = _eager_calls(eng, devs[0])
    rows = _whole_calls("squeezenet_dynamic", calls, counts, forwards,
                        lambda *a: None,
                        _qop_no_library("qconv_int8_requant",
                                        QOP_LABELS["convinteger"]))
    line = {"phase": "int8_whole", "path": "squeezenet_dynamic",
            "model": "squeezenet1.0 in onnxruntime quantize_dynamic form "
                     "(QInt8 weights, per tensor)",
            "size": "224x224", "batch": BATCH,
            "images_per_s": BATCH / ms * 1e3, "forward_ms": ms,
            "launches": counts, "splits": splits,
            "input_zero_points": zps, "replays_equal_eager": 2,
            "kernel_calls_equal_plain": len(calls), "kernels": rows,
            "seconds": time.perf_counter() - t0, "card": smi}
    emit(line)
    return rows


def _whole_runtime_zp(smi: str) -> dict:
    """One-node QLinearConv, QLinearMatMul and QGemm whose x (a) and y
    zero points are graph inputs (computed before the node, as far as it
    knows): each Engine's first call (eager) and a replay with other zero
    points, both bit-equal to the plain versions (the CPU Engine); the
    kernels read the zero points from device memory."""
    import onnx_rusty_inference_engine_tpu_torch as P

    t0 = time.perf_counter()
    rng = np.random.default_rng(6)
    cases = {
        "QLinearConv": (
            ["x", "x_s", "x_zp", "w", "w_s", "w_zp", "y_s", "y_zp", "b"],
            {"x_s": np.float32(0.05),
             "w": rng.integers(-127, 128, (64, 32, 3, 3)).astype(np.int8),
             "w_s": np.float32(0.004), "w_zp": np.int8(0),
             "y_s": np.float32(0.4),
             "b": rng.integers(-4000, 4000, 64).astype(np.int32)},
            {"x": ((32, 32, 28, 28), np.uint8)}, {"kernel_shape": [3, 3],
                                                  "pads": [1, 1, 1, 1]},
            "", "qconv_int8_requant"),
        "QLinearMatMul": (
            ["x", "x_s", "x_zp", "w", "w_s", "w_zp", "y_s", "y_zp"],
            {"x_s": np.float32(0.04),
             "w": rng.integers(-127, 128, (768, 768)).astype(np.int8),
             "w_s": np.float32(0.002), "w_zp": np.int8(0),
             "y_s": np.float32(0.5)},
            {"x": ((512, 768), np.uint8)}, {}, "", "qmatmul_int8"),
        "QGemm": (
            ["x", "x_s", "x_zp", "w", "w_s", "w_zp", "b", "y_s", "y_zp"],
            {"x_s": np.float32(0.03),
             "w": rng.integers(-127, 128, (1000, 1024)).astype(np.int8),
             "w_s": np.float32(0.002), "w_zp": np.int8(0),
             "b": rng.integers(-2000, 2000, 1000).astype(np.int32),
             "y_s": np.float32(0.4)},
            {"x": ((256, 1024), np.uint8)}, {"transB": 1}, "com.microsoft",
            "qmatmul_int8"),
    }
    out = {}
    for op, (inputs, consts, feeds, attrs, domain, kernel) in cases.items():
        feeds = {**feeds, "x_zp": ((), np.uint8), "y_zp": ((), np.uint8)}
        g = _one_node_graph(op, inputs, consts, feeds, attrs, domain)
        xv = rng.integers(0, 256, feeds["x"][0]).astype(np.uint8)
        zsets = [(np.uint8(131), np.uint8(120)), (np.uint8(7), np.uint8(250))]
        reset_counts()
        eng = P.Engine(g)
        cpu = P.Engine(g, device="cpu")
        got = []
        for zx, zy in zsets:
            f = {"x": xv, "x_zp": np.asarray(zx), "y_zp": np.asarray(zy)}
            got.append((eng(f)["y"].cpu().numpy(), cpu.run(f).outputs["y"]))
        counts = {k: v for k, v in read_counts().items() if v}
        splits = read_splits(kernel)
        require(len(eng._graphs) == 1 and counts == {kernel: 2}
                and splits["forms"]["device_zero_point"] == 2,
                f"runtime_zp {op}: one eager launch and one replayed, both "
                f"reading y's zero point from the device: {counts} "
                f"{splits}")
        for i, (card, want) in enumerate(got):
            require(np.array_equal(card, want),
                    f"runtime_zp {op}: {'eager' if i == 0 else 'replayed'} "
                    f"== the plain versions (zero points {zsets[i]})")
        require(not np.array_equal(got[0][0], got[1][0]),
                f"runtime_zp {op}: the zero points move the output")
        out[op] = {"launches": counts, "forms": splits["forms"],
                   "eager_and_replayed_equal_plain": True}
    line = {"phase": "int8_whole", "path": "runtime_zp", "nodes": out,
            "seconds": time.perf_counter() - t0, "card": smi}
    emit(line)
    return line


def _whole_bf16_input(smi: str) -> dict:
    """A graph with a BFLOAT16 input, parsed from ONNX bytes (import_onnx,
    the native parser), fed a bf16 tensor: the input spec is bf16, the
    outputs equal the CPU Engine's, eager and replayed."""
    import tempfile

    import onnx_rusty_inference_engine_tpu_torch as P
    from onnx_rusty_inference_engine_tpu_torch import onnx_io

    t0 = time.perf_counter()
    g = onnx_io.GraphProto(name="bf16_input")
    g.inputs.append(onnx_io.ValueInfo(name="x", elem_type=onnx_io.BFLOAT16,
                                      shape=[64, 4096]))
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4096,)).astype(np.float32)).to(torch.bfloat16)
    g.initializers = {"w": w}
    g.nodes = [onnx_io.NodeProto("Cast", ["x"], ["xf"], attributes={
                   "to": onnx_io.Attribute(name="to", i=onnx_io.FLOAT)}),
               onnx_io.NodeProto("Cast", ["w"], ["wf"], attributes={
                   "to": onnx_io.Attribute(name="to", i=onnx_io.FLOAT)}),
               onnx_io.NodeProto("Mul", ["xf", "wf"], ["y"])]
    g.outputs = [onnx_io.ValueInfo(name="y")]
    model = onnx_io.ModelProto(graph=g, opset_version=13,
                               opset_imports={"": 13})
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        path = os.path.join(d, "bf16_input.onnx")
        onnx_io.save_model(path, model)
        graph = P.import_onnx(path)
    require(graph.inputs[0].dtype == torch.bfloat16,
            f"bf16_input: the input spec is bf16: {graph.inputs[0]}")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (64, 4096)).astype(np.float32)).to(torch.bfloat16)
    eng, cpu = P.Engine(graph), P.Engine(graph, device="cpu")
    want = cpu({"x": x})["y"]
    got = [eng({"x": x.cuda()})["y"].cpu() for _ in range(2)]
    require(len(eng._graphs) == 1
            and all(torch.equal(v, want) for v in got),
            "bf16_input: the card's outputs (eager, replayed) == the CPU's")
    line = {"phase": "int8_whole", "path": "bf16_input",
            "input": {"name": "x", "dtype": "bfloat16", "shape": [64, 4096]},
            "output_dtype": str(want.dtype), "eager_and_replayed_equal_cpu": True,
            "seconds": time.perf_counter() - t0, "card": smi}
    emit(line)
    return line


def phase_int8_whole(smi: str) -> list:
    """The INT8 path and the front end made whole: the native parser,
    R3D-18 INT8 (3-D QLinearConv), the depthwise 3-D conv and a 3-D
    ConvInteger, ORT's dynamically quantized SqueezeNet (run-time zero
    points through a captured graph), one-node run-time zero points, a
    bf16 graph input. Returns the kernels line's rows of the new
    instances."""
    t0 = time.perf_counter()
    _whole_native(smi)
    r3d = _whole_r3d(smi)
    torch.cuda.empty_cache()
    dw = _whole_depthwise3d(smi)
    sqd = _whole_squeezenet_dynamic(smi)
    torch.cuda.empty_cache()
    _whole_runtime_zp(smi)
    _whole_bf16_input(smi)
    emit({"phase": "int8_whole", "path": "done",
          "seconds": time.perf_counter() - t0})
    rows = []
    for kname, label, v, per in (
            ("qconv_int8_requant",
             "3-D: staged-halo producer (13 stride-1 3x3x3, the stem as "
             "its space-to-depth rewrite) and gather (strided, shortcuts): "
             "R3D-18 INT8",
             r3d["qconv_int8_requant"],
             f"one R3D-18 INT8 forward (b{WHOLE_BATCH} clips of "
             f"3x16x112x112): the sums of its 20 launches"),
            ("qconv_grouped_int8_requant",
             "3-D depthwise 3x3x3 (tile3d form)",
             dw["qconv_grouped_int8_requant"],
             f"one launch at {list(DW3D_SHAPE)}, group 64"),
            ("qconv_int8_requant",
             "device zero point: ORT dynamic SqueezeNet ConvInteger "
             "(int32 epilogue, uint8 x)",
             sqd["qconv_int8_requant"],
             f"one SqueezeNet 1.0 forward (224x224, b{BATCH}): the sums of "
             f"its 26 launches")):
        source, replaces = KERNEL_ROWS[kname]
        rows.append({
            "name": kname, "instance": label, "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": v["launches"], "max_abs_err": 0, "ms": v["ms"],
            "plain_ms": v["plain_ms"], "plain_per": v["plain_per"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": v["library_ms"], "library": v["library"],
            "layout_copy_ms": v["layout_copy_ms"],
            "per": per, "by_plan": v.get("by_plan"),
            "int8_whole_path": True, "card": smi})
    return rows


# --------------------------------------------------------------------------
# 6e. parallel: the mesh on the card, a world of one rank on NCCL
# --------------------------------------------------------------------------
PAR_NEW = 16       # new tokens per GPT-2 run and per served request
PAR_DL = 8         # the device loop's K
PAR_ITERS = 5      # replayed forwards timed per SqueezeNet Engine


def _north_star(mesh):
    """tests/test_gpt2.py's north-star rule on the port's placements: the
    packed int4 weights [N, K/2] on N, their scales [2 nbh, N] on N, other
    2-D weights whose last dim divides by 4 on it, over "model"."""
    from onnx_rusty_inference_engine_tpu_torch.parallel.sharding import (
        placements, replicated)

    def rule(name, arr):
        if name.endswith("__w4") and arr.ndim == 2:
            return placements(mesh, {"model": 0})
        if name.endswith("__w4s") or (arr.ndim == 2
                                      and arr.shape[-1] % 4 == 0):
            return placements(mesh, {"model": 1})
        return replicated(mesh)

    return rule


def _par_line(path: str, t0: float, mesh, smi: str, **kw) -> None:
    import torch.distributed as dist

    emit({"phase": "parallel", "path": path,
          "backend": str(dist.get_backend()),
          "world_size": dist.get_world_size(),
          "mesh": dict(zip(mesh.mesh_dim_names,
                           (int(n) for n in mesh.shape))),
          "seconds": time.perf_counter() - t0, "nvidia_smi": smi, **kw})


def _replayed_ips(eng, feed, batch: int) -> float:
    """images/s of eng's replayed graph (CUDA events, PAR_ITERS calls)."""
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in feed.items()}
    eng(dev)
    return batch / (cuda_ms(lambda: eng(dev), PAR_ITERS) / 1e3)


PAR_RUNS = 3       # timed runs per Generator and loop, after a warm one


def _par_generate(gen, prompts, dl: int):
    """(tokens, int4 and attention launches of one run, median wall s of
    PAR_RUNS) of PAR_NEW-token runs at device_loop `dl`, after a warm run
    (captures)."""
    gen.device_loop = dl
    gen.generate(prompts, PAR_NEW)
    walls = []
    for i in range(PAR_RUNS):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = gen.generate(prompts, PAR_NEW)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            c = read_counts()
    return toks, {k: c[k] for k in ("qmatmul_int4_planar",
                                    "decode_attention_int8")}, \
        float(np.median(walls))


def phase_parallel(smi: str) -> dict:
    """The mesh paths on the card, a world of one rank on NCCL, each held
    to its unsharded run: (a) SqueezeNet INT8 b256 through a sharded
    Engine (cnn_param_sharding, data_input_sharding), (b) GPT-2 124M's
    widths at GPT2_SIDE_LAYERS layers tensor-sharded by the north-star
    rule (INT4 + INT8 KV + fused attention; host loop and device_loop),
    (c) the same model pipelined over {pipe: 1} (unfused), (d) a sharded
    DecodeServer. Returns {kernel: {path: launches}}."""
    import onnx_rusty_inference_engine_tpu_torch as P
    import torch.distributed as dist
    from onnx_rusty_inference_engine_tpu_torch.generate import Generator
    from onnx_rusty_inference_engine_tpu_torch.models.gpt2 import GPT2Config
    from onnx_rusty_inference_engine_tpu_torch.parallel import (
        cnn_param_sharding, data_input_sharding, make_mesh)
    from onnx_rusty_inference_engine_tpu_torch.serve_llm import DecodeServer

    out: dict = {}
    mesh = make_mesh({"data": 1, "model": 1})
    require(dist.get_backend() == "nccl", "an NCCL process group on the card")

    # (a) SqueezeNet 1.0 INT8, 224x224, b256
    t0 = time.perf_counter()
    graph = P.import_model(P.build_squeezenet())
    x = np.random.default_rng(0).standard_normal(
        (BATCH, 3, 224, 224)).astype(np.float32)
    feed = {"data_0": x}
    qgraph = P.quantize_graph(graph, ranges=P.calibrate(
        graph, [{"data_0": x[:CALIB]}]))
    plain = P.Engine(qgraph)
    want = plain(feed)["softmaxout_1"]
    eng = P.Engine(qgraph, mesh=mesh,
                   param_sharding_fn=cnn_param_sharding(mesh),
                   input_sharding_fn=data_input_sharding(mesh))
    reset_counts()
    got = eng(feed)["softmaxout_1"]
    launches = read_counts()["qconv_int8_requant"]
    require(launches == 26, f"26 qconv_int8_requant launches a sharded "
            f"forward, got {launches}")
    require(bool(torch.equal(got, want)),
            "sharded INT8 SqueezeNet bit-equal to the unsharded Engine")
    routes = eng.shard_routes
    again = eng(feed)["softmaxout_1"]
    require(bool(torch.equal(again, got)),
            "sharded INT8 SqueezeNet's replay bit-equal to its eager run")
    ips = _replayed_ips(eng, feed, BATCH)
    ips_plain = _replayed_ips(plain, feed, BATCH)
    out["qconv_int8_requant"] = {"squeezenet_int8": launches}
    _par_line("squeezenet_int8", t0, mesh, smi, shard_routes=routes,
              launches={"qconv_int8_requant": launches},
              images_per_s=ips, unsharded_images_per_s=ips_plain,
              bit_equal=True, replay_equal=True)
    del plain, eng, want, got, again
    torch.cuda.empty_cache()

    # (b) GPT-2 124M's widths, tensor-sharded by the north-star rule
    cfg = GPT2Config(n_layer=GPT2_SIDE_LAYERS)
    prompts = _decode_prompts(cfg)
    kw = dict(kv_dtype="int8", int4_weights=True, fused_attention=True)
    for path, mkw, ref_kw in (
            ("gpt2_tensor", dict(mesh=mesh,
                                 param_sharding_fn=_north_star(mesh)), kw),
            ("gpt2_pipeline", dict(mesh=make_mesh({"pipe": 1}),
                                   pipeline_axis="pipe"),
             dict(kv_dtype="int8", int4_weights=True))):
        t0 = time.perf_counter()
        ref = _generator(cfg, **ref_kw)
        gen = _generator(cfg, **ref_kw, **mkw)
        line = {}
        for dl in (0, PAR_DL):
            want, c_want, w_want = _par_generate(ref, prompts, dl)
            toks, c, w = _par_generate(gen, prompts, dl)
            require(np.array_equal(toks, want),
                    f"{path} device_loop={dl}: tokens equal the unsharded "
                    f"Generator's")
            require(c == c_want, f"{path} device_loop={dl}: launches {c} "
                    f"equal the unsharded {c_want}")
            tok = DEC_BATCH * PAR_NEW
            line[f"device_loop_{dl}"] = {
                "launches": c, "tokens_per_s": tok / w,
                "unsharded_tokens_per_s": tok / w_want}
            for k, n in c.items():
                if n:
                    out.setdefault(k, {})[f"{path}_dl{dl}"] = n
        routes = (gen.decode.shard_routes if path == "gpt2_tensor" else
                  {"stages": gen.decode.n_stages,
                   "layers_per_stage": gen.decode.layers_per_stage})
        _par_line(path, t0, mkw["mesh"], smi, shard_routes=routes,
                  tokens_equal=True, **line)
        del ref, gen
        torch.cuda.empty_cache()

    # (d) DecodeServer, 8 slots, 8 requests x PAR_NEW tokens
    t0 = time.perf_counter()
    reqs = _serve_requests(cfg)[:SERVE_SLOTS]
    served = {}
    for name, skw in (("unsharded", {}),
                      ("sharded", dict(mesh=mesh,
                                       param_sharding_fn=_north_star(mesh)))):
        srv = DecodeServer(cfg, slots=SERVE_SLOTS, prompt_len=PROMPT,
                           max_len=MAX_LEN, kv_dtype="int8",
                           int4_weights=True, autostart=False, **skw)
        warm = srv.submit(reqs[0], 2)  # a first request captures graphs
        srv.start()
        warm.result(timeout=600)
        reset_counts()
        t1 = time.perf_counter()
        futs = [srv.submit(p, PAR_NEW) for p in reqs]
        toks = [[int(t) for t in f.result(timeout=600)] for f in futs]
        wall = time.perf_counter() - t1
        c = read_counts()
        served[name] = (toks, wall, c["qmatmul_int4_planar"],
                        srv.decode.shard_routes)
        srv.stop()
    require(served["sharded"][0] == served["unsharded"][0],
            "sharded DecodeServer's tokens equal the unsharded server's")
    out.setdefault("qmatmul_int4_planar", {})["decode_server"] = \
        served["sharded"][2]
    tok = SERVE_SLOTS * PAR_NEW
    _par_line("decode_server", t0, mesh, smi,
              shard_routes=served["sharded"][3], tokens_equal=True,
              int4_launches=served["sharded"][2],
              unsharded_int4_launches=served["unsharded"][2],
              tokens_per_s=tok / served["sharded"][1],
              unsharded_tokens_per_s=tok / served["unsharded"][1])
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    require(torch.cuda.is_available(),
            "a CUDA device (torch.cuda.is_available() is false)")
    require(os.path.isdir(os.path.join(HERE, PKG)),
            f"the package {PKG}/ beside this script")
    sys.path.insert(0, HERE)
    from onnx_rusty_inference_engine_tpu_torch.models import host_memo

    t_start = time.perf_counter()
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # host_memo: the GPT-2 and Llama graphs of one config and seed, in
        # every phase, draw and pack their weights once
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False), host_memo():
            smi = phase_device()
            phase_build()
            eng, qgraph, eng8, card, launches, feed = phase_slice()
            phase_profile(eng, eng8, feed)
            rows = [phase_kernels(qgraph, eng8, card, launches, smi)]
            phase_capture("squeezenet1.0 int8 224x224", eng8, feed,
                          "qconv_int8_requant", 26,
                          {"producers": dict(SQUEEZENET_PRODUCERS),
                           "epilogues": {"int32": 0, "requant": 26},
                           "forms": {**_no_forms("qconv_int8"), "s2d": 1}},
                          {"data_0": np.random.default_rng(1).standard_normal(
                              feed["data_0"].shape).astype(np.float32)})
            del eng, eng8, card
            torch.cuda.empty_cache()
            gen, prompts, counts, counts_i8, toks, toks_i8 = phase_decode()
            phase_decode_profile(gen, prompts)
            phase_device_loop(gen, prompts, toks, toks_i8)
            rows += phase_decode_kernels(gen, prompts, counts, counts_i8,
                                         smi)
            lora = phase_families_lora(gen, prompts, smi)
            del gen
            torch.cuda.empty_cache()
            phase_attn_sweep(smi)
            eng, eng8, qgraph, card, launches, feed = phase_bert()
            phase_profile(eng, eng8, feed, model="bert-base ",
                          batch=BERT_BATCH, buckets_by=_BERT_BUCKETS,
                          glue_op="QLinearMatMul")
            rows.insert(1, phase_bert_kernels(qgraph, eng8, card, launches,
                                              smi))
            phase_capture("bert-base int8 B32 T128", eng8, feed,
                          "qmatmul_int8", 73,
                          {"epilogues": {"int32": 0, "requant": 73},
                           "forms": _no_forms("qmatmul_int8")},
                          {k: np.roll(v, 1, axis=0) for k, v in feed.items()})
            del eng, eng8, card
            torch.cuda.empty_cache()
            gen_ort, counts_ort = phase_ort_decode()
            rows.insert(2, int4_kernel_row(gen_ort, "qmatmul_int4_bf16",
                                           counts_ort["qmatmul_int4_bf16"],
                                           smi))
            del gen_ort
            torch.cuda.empty_cache()
            phase_int4_sweep(smi)
            phase_serve(smi)
            llama = phase_llama(smi)
            scan = phase_scan_decode(smi)
            for row in rows:
                if row["name"] == "qmatmul_int4_planar":
                    row["scan_path"] = scan
            phase_control_flow(smi)
            rows += phase_precision(smi)
            for row in rows:
                if row["name"] in llama:
                    row["llama_path"] = llama[row["name"]]
            vision, grouped = phase_vision(smi)
            for row in rows:
                if row["name"] in vision:
                    row["vision_path"] = vision[row["name"]]
            rows.insert(1, grouped)
            rows += phase_qoperator(smi)
            phase_export(smi)
            unet = phase_op_library(smi)
            next(row for row in rows if row["name"] == "qconv_int8_requant"
                 )["unet_path"] = unet
            phase_detection_ml(smi)
            fam = phase_families(smi, lora)
            for row in rows:
                if row["name"] in fam and "instance" not in row:
                    row["families_path"] = fam[row["name"]]
            dec = phase_decoding(smi)
            for row in rows:
                if row["name"] in dec and "instance" not in row:
                    row["decoding_path"] = dec[row["name"]]
            beam = dec["qmatmul_int4_planar"]
            rows += phase_int8_whole(smi)
            par = phase_parallel(smi)
            for row in rows:
                if row["name"] in par and "instance" not in row:
                    row["parallel_path"] = par[row["name"]]
            rows.append(phase_nibble(
                counts["qmatmul_int4_planar"]
                + counts_ort["qmatmul_int4_bf16"]
                + llama["qmatmul_int4_planar"]["launches"]
                + scan["launches"]
                + sum(p["launches"] for p in fam.get(
                    "qmatmul_int4_planar", {}).values())
                + beam["beam_host_loop"] + beam["beam_device_loop"]
                + sum(par.get("qmatmul_int4_planar", {}).values()), smi))
            emit({"phase": "done", "seconds": time.perf_counter() - t_start})
            emit({"kernels": rows})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    return _finish_ok()


def _finish_ok() -> int:
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--export-child"]:
        sys.exit(export_child(sys.argv[2:]))
    sys.exit(main())
