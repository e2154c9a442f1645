#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`mico_tpu_torch`) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase, one card

Phases, run in order (any failure exits non-zero):
  1. device: the card's name and power limit, and the kernels' build time
     (nvcc over `mico_tpu_torch/csrc/*.cu`, at first use, into `build/`);
  1b. audio_decode: the host's audio decoder (g++ over
     `mico_tpu_torch/csrc/audio_decode.cpp`, into `build/`): 10 s 44.1 kHz
     stereo FLACs at 16 and 24 bits (all four channel assignments, LPC and
     FIXED subframes) decoded equal to the PCM they were written from, bit
     for bit; the C++ resampler held to its numpy plain version
     (`audio_io.resample_plain`: the same length, max |d| <= 1e-6) from
     22050, 44100, 48000 and 16001 Hz to 16 kHz; the host's decode,
     resample and decode + resample rates in seconds of audio a second;
  2. kernels: K1, K2 and K7 against their plain PyTorch versions on the card
     in bf16, at the main paths' shapes and layouts (the tensors that are
     then timed) and at smaller and biased cases, with their times beside
     the plain version, a PyTorch yardstick and the card's bound; K1 at
     (8, 257, 1408), a ragged (2, 300, 80) with two heads of 40, odd
     counts of 64-column k-steps (2, 40, 48) with two heads of 24 and (4,
     257, 960) with 15 heads of 64, rows of three key blocks (2, 600, 1408)
     and the bench ViT pass (112, 257, 1408), the demo's ViT passes (1,
     2 and 4 x 257 x 1408: a ragged third M-tile of the GEMM, 16 to 64
     attention blocks) and the EVA-CLIP image pass (16, 257, 1408), each
     with the LN affine on
     and off (also mean |d| <= 1e-2 * mean |ref|), and its GEMM stage alone
     (`ln_gemm_bias`) at the bench pass; K1's device ms by stage (statistics, GEMM,
     attention) beside F.layer_norm, F.linear and SDPA; K2 also
     at cases that cross its splits of the keys (one query row over 1028
     keys, 8192 keys, a ragged 8100, the decode with a (1, 1, 1, 1028) bias
     masking every key of its second split, the long-context step's causal
     (2, 12, 128, 128) self-attention with its bias, the demo's ITM q (2,
     12, 30, 64) over 257 keys without a bias as the path runs it and with
     a padding bias), and as the EVA02 towers' self-attention (q, k, v of
     EVA02-L's bench pass (112, 16, 257, 64) with v a strided view of the
     (112, 257, 3072) qkv product, without and with a unit-std (1, 16, 257,
     257) fp32 relative bias; EVA02-L-336's (16, 16, 577, 64); EVA02-B's
     (16, 12, 197, 64); also mean |d| <= 1e-2 * mean |ref|, each labelled
     with its plan: row warps, key warps, splits), and at ITM and the
     decode its device time per call (torch.profiler), its host time per
     call, its plan (splits, key warps) and roofline share beside SDPA's
     device and host time, and at the EVA02-L pass (with and without the
     bias) its event and device ms beside its plain version, SDPA's (the
     bias as a float mask) and the bound; K7 at the four decode shapes (beam vision (64,
     6, 2056), greedy vision (64, 2, 2056), audio beam (128, 6, 514), one
     video caption (1, 6, 1028)), at Lq 1, 9 and 16 (the n16 tile), B 8
     (96 items, fewer than the SMs), B 3 over 257 keys, and on its large
     plan (Lk 9108 at Lq 6; 6 heads), each labelled with its `k7_plan`,
     under the absolute gates and mean |d| <= 1e-2 * mean |ref|, and at the
     beam shape its device and host time per call, plan and roofline share
     beside the library route's device time by stage (dequantise K, V,
     SDPA); then K5
     and K8 (the post-norm block's projection-fused attention, and with the
     output projection) at the bigE ViT pass x (112, 257, 1792) 16 x 112,
     at (8, 257, 1408) 16 x 88, at (3, 50, 256) 4 x 64 and at (2, 600,
     1792) 16 x 112 (three key blocks: the attention's streamed path;
     unit-std x, weights at the init std 0.02; also mean |d| <= 1e-2 *
     mean |ref|),
     and their GEMM stage alone (`bf16_gemm_bias`, the C entry
     `mico_bf16_gemm_bias`) against its plain product at the qkv and the
     out-projection shape of the bigE pass and the ragged tail's qkv, under
     the same gates; timed at the first beside F.linear + SDPA (+ F.linear),
     with each call's device ms by stage (the GEMM, the attention, K8's
     out-projection) beside one F.linear at each GEMM's shape and SDPA;
  3. main: the full-width MiCo-ViT-g omni step (S = 16: 1 image + 4 video
     frames + 2 audio slices in one 112-frame ViT pass, BERT over (16, 30)
     tokens, heads, similarity), ITM for 1 image x 3 captions, and
     `EmbeddingPipeline.embed_texts` and `_run`, with random weights from
     seed 0; each path runs with the launch counts set to 0 just before it,
     and its own counts are held to it (K1 40 per ViT pass, K2 12 per ITM
     pass, K7 0);
  4. cosine: the same one-sample inputs through the port on the CPU in fp32
     (the plain versions) against the card's bf16 output: each embedding at
     cosine >= 0.999, ITM probabilities within 1e-2;
  5. caption: one image and one 4-frame video through the ViT and
     `get_multimodal_forward_input_vision`, then beam-3 captions (40 new
     tokens, length penalty 0.6) on the bf16 and the int8 (K7) routes, a
     beam-3 answer to a tokenised question on the int8 route, and a
     recompute greedy caption of the video (K2, Lq·Lk = 10 x 1028), each
     path counted from 0 and held to its counts (K7 480 per int8 caption,
     120 per int8 answer; K2 96 for the 8-token recompute; 0 on the bf16
     cached beam); the captions are decoded and printed. Then the card's
     bf16 greedy caption of the image step by step against the CPU fp32
     port teacher-forced on the card's tokens (logits cosine >= 0.999 at
     every step, the same token wherever the fp32 top-1 margin is >= 0.05),
     the int8 route's teacher-forced logits against the bf16 route's
     (cosine >= 0.999) with the two routes' free-running token agreement,
     and the decode times at the captioner deployment shape (B 64, a
     (64, 2056, 768) condition, 40 new tokens): beam-3 and top-k-10
     sampling on the bf16 route (packed and split-heads cross K/V) and the
     int8 route, median of 5 after a warm-up;
  5b. demo: `mico_tpu_torch.inference_demo.run_demo` from a
     released-layout directory written to a temporary directory
     (`log/hps.json` of the MiCo-g run, `ckpt/model_step_1200.pt` with all
     897 entries of `tests/fixtures/mico_vit_g_manifest.json` in fp16,
     drawn from seed 0: LN weights 1, biases 0, the rest N(0, 0.02); an
     older `model_step_600.pt` and an unfinished `model_step_2400-tmp`
     beside it) and media files written beside it (a 320 x 240 PPM image,
     8 PPM frames, a 10 s 44.1 kHz stereo 16-bit FLAC, which the demo
     decodes and resamples to 16 kHz): on the card in bf16, each stage
     counted from 0 (K1 40 for each of the image, video and audio ViT
     passes, K2 12 for ITM, K7 0; text and the beam-3 caption launch
     none), every manifest entry but the three non-weights read, then the
     same directory and files on the CPU in fp32: image, video, audio and
     text embeddings at cosine >= 0.999, ITM within 1e-2, the card's caption
     tokens in the vocabulary; it prints the wall time split into load,
     decode + preprocess and device work, and the host RSS before, at the
     end of the load and over the run;
  5c. orbax: `.orbax` checkpoints without JAX: the host zstd decoder
     (g++ over `mico_tpu_torch/csrc/zstd_decode.cpp`, its seconds); the
     committed fixtures `tests/fixtures/orbax/` (JAX's one-process save
     with a 4-device leaf, and its two-process merged save, model and
     optimizer) held bit for bit to their numpy recipe
     (`tests/torch_orbax_recipe.py`); MiCo-ViT-g's fp32 weights drawn on
     the card, saved by `ModelSaver(backend="orbax")`, loaded by
     `load_from_pretrained_dir` and placed in bf16: the
     `EmbeddingPipeline` image (K1 40) and text embeddings bit for bit
     those of the live model's bf16 copy, with write and read seconds and
     GB/s and the host's peak RSS; then `mico_tpu_torch.run` at ViT-g width
     with RUN_RESUME_LAYERS blocks and `checkpoint_backend=orbax`: 2 steps,
     and a resume to step 4 whose loaded weights and moments equal the
     saved ones bit for bit (K3, K4 counted over the resumed steps);
  6. bigE: MiCo on EVA02-CLIP-bigE-14-plus (`vision_encoder_type=
     "evaclip02_bige"`: 64 post-norm blocks, width 1792, 16 heads of 112,
     MLP 15360; 4.35 B tower parameters) at full width and depth, fp32
     weights drawn once from seed 0 on the card and a bf16 copy of them:
     the omni step (S = 16, one 112-frame ViT pass; K5 64, every other
     kernel 0; median ms of 5, samples/s, peak memory), ITM (K5 64, K2 12),
     `EmbeddingPipeline._run` over 20 images with one failure on the folded
     copy (K5 3 x 64), the omni step with `FUSED_ATTN_PROJ` on (K8 64, K5
     0; embeddings at cosine >= 0.999 to the K5 route's), then the same
     one-sample inputs through the fp32 weights on the plain routes on the
     card (TF32 off) against the bf16 output: each embedding at cosine >=
     0.999; the image's ViT tokens on the kernel route no further from
     fp32 than 1.05 x the bf16 plain route's (the kernels add no error of
     their own); the bf16 ITM path (BERT, K2) over the fp32 tower's tokens
     within 1e-2 of the fp32 ITM probabilities; the whole bf16 route's ITM
     gap reported (at seed 0 the tower's near-argmax attention makes it
     scatter over images with an rms of 5-7e-3 on every bf16 route);
  6b. CLIP: MiCo on the OpenAI-CLIP ViT-L/14 tower
     (`vision_encoder_type="clip_vit_large_14_336px"`, which JAX maps to
     224 px: 24 blocks, width 1024, 16 heads of 64, 257 tokens) at full
     width and depth, fp32 weights drawn once from seed 0 on the card and a
     bf16 copy: the omni step (K3 24, every other kernel 0; median ms of 5,
     samples/s) and ITM (K3 24, K2 12), then both again with
     `PACKED_CLS_SPLIT` on (K9 24, K3 0); each route's embeddings at cosine
     >= 0.999 and its ITM within 1e-2 of the same one-sample inputs through
     the fp32 weights on the plain routes on the card (TF32 off);
  6c. eva_clip: EVA-CLIP zero-shot classification on EVA01-CLIP-g-14
     (`models.clip_text.create_model`: the ViT-g image tower, 40 pre-norm
     blocks of width 1408, 16 heads of 88, 257 tokens at 224 px, its head
     to 1024; the text tower, 12 layers of width 768, 12 heads, context 77,
     projection to 1024) at full width and depth, fp32 weights drawn once
     from seed 0 on the card and a bf16 copy of the towers (logit_scale
     kept fp32, as JAX keeps it): a CLIP-format merges file written to a
     temporary directory spells the prompts' words, and the port's
     regex-free `ClipBpeTokenizer` turns 10 class names x 2 templates into
     (20, 77) ids; then B 16 random 224-px images through
     `clip_encode_image` (K1 40, nothing else), the classifier's 20 prompts
     through `build_zero_shot_classifier` and the logits
     `img @ W.T * exp(logit_scale)`, counted from 0 as one path; against
     the same through the fp32 weights on the plain routes on the card
     (TF32 off): image features cosine >= 0.999 per row, the classifier's
     rows cosine >= 0.999, softmax probabilities within 1e-2; then CLIP's
     RN50 (`models.modified_resnet`, 224 px, B 16; no kernel), its first
     BN's scale set by an fp32 pass so the trunk's map has unit RMS (see
     `scale_to_unit_map`), bf16 against fp32 on the card: the forward's
     output at cosine >= 0.999 per row; the image pass, the text pass and
     RN50 in ms (median of 5 after a warm-up), and the phase's seconds;
  6d. EVA02: MiCo on EVA02-CLIP-L-14 (`vision_encoder_type=
     "evaclip02_large"`: 24 pre-norm blocks, width 1024, 16 heads of 64,
     SwiGLU 2730, sub-LN, RoPE, 257 tokens) at full width and depth, fp32
     weights drawn once from seed 0 and a bf16 copy: the omni step (K2 24,
     every other kernel 0; median ms of 5, samples/s, peak memory, the
     device ms of one step split into K2 and the rest), ITM (K2 24 + 12),
     `EmbeddingPipeline._run` over 20 images with one failure on the folded
     copy (K2 3 x 24), each embedding at cosine >= 0.999 and ITM within 1e-2
     of the fp32 weights on the plain routes on the card (TF32 off); three
     `ret%tva_cap%tva` steps at B 8 on the fp32 weights in bf16 (K2 48 a
     step: its forward under autograd, the plain recompute backward; finite
     losses; ms/step, peak memory); the gradient check at B 2 (rates 0,
     draws injected): bf16 (K2 alone) against fp32 on the plain routes,
     each loss within 2e-2 relative, cosine >= 0.99 per optimizer group and
     for the first and last block's qkv_w;
  6e. swin: MiCo on Swin-B (`swin_base_patch4_window7_224_22k`) and on
     VideoSwin-B (`videoswin_base`) at full width (embed 128, depths
     2/2/18/2, heads 4/8/16/32, windows 7 and (8, 7, 7)): `_run` over 16
     images and over 16 4-frame videos and `embed_texts` (no launch: the
     towers have no kernel), ITM on a 4-frame video (K2 12: 30 x 196
     condition tokens) and on an image (30 x 49: plain math, no launch);
     the image, video and text embeddings at cosine >= 0.999 and the video
     ITM within 1e-2 of the fp32 weights on the card; ms per embedded
     batch of 8 and peak memory;
  7. train: K3 and K4 against their plain versions on the card in bf16 at
     the train step's vision pass (32, 257, 16 x 88), at (3, 50, 4 x 64),
     at (2, 600, 16 x 88) (rows of three key blocks) and at the
     long-context step's vision pass (64, 257, 16 x 88), each on both
     layouts (column slices of the fused qkv, three contiguous tensors;
     K4 also into one (B, L, 3W) dqkv), timed beside the plain versions,
     SDPA (forward; its autograd backward alone) and the bound; K3's device
     ms beside SDPA's there and at CLIP-L/14's (112, 257, 3 x 16 x 64);
     K4's device ms by launch at the train and the long-context pass
     beside SDPA's backward alone, in device ms, with each backend that
     takes the shape pinned (flash, cuDNN, memory-efficient); then six
     full-width pretraining steps of `configs/pretrain-omni.json`'s task
     ret%tva_cap%tva (B = 8 samples of
     4 frames, 2 audio slices and a 40-token caption; fp32 master weights
     and AdamW moments from seed 0, bf16 compute, dropout and drop-path on,
     the same draws every step), each counted from 0 (K3 80 and K4 80 per
     step, K1/K2/K7 0), finite losses, the last step's total below the
     second's (the first with a non-zero learning rate), ms/step,
     samples/s, model TFLOP/s and peak memory, and one more step under
     torch.profiler (device busy ms and the idle share of the median
     step); then the gradient check: at
     B = 2 with every rate 0 and the draws injected, the card in bf16 (K3,
     K4, K2 and its backward) and in bf16 with `PACKED_CLS_SPLIT` on (K9 80,
     K3 0, K4 80 over the vision and audio passes) against the card in fp32
     on the plain routes, each loss within 2e-2 relative and the gradient
     cosine >= 0.99 for each optimizer group and the first and last block's
     qkv_w. Between the two, K9 against its plain version on unit-std qkv at
     the train pass (32, 257, 3 x 16 x 88), CLIP-L/14's (112, 257, 3 x 16 x
     64), (8, 257, 3 x 16 x 112), (2, 385, 3 x 4 x 64) and (1, 513, 3 x 4
     x 88) (the patch keys stream past 273 tokens; the K3 gates), timed at
     CLIP-L's and the train pass's beside K3 on the same input, the plain
     version, SDPA and the bound, in event and device ms;
  8. long-context: K6 (with and without the LSE) and K6b (dq, dk, dv)
     against their plain versions in bf16 on unit-std inputs at the
     long-context step's cross-attention (2, 12, 128, 8224, 64) in BERT's
     strided layout, with no bias and with a (2, 1, 1, 8224) padding bias,
     at a ragged (1, 2, 160, 9000, 88), at one query row (2, 12, 1, 8224,
     64) and with a (2, 1, 1, 8224) bias masking every key of K6's fourth
     split and of the K6b split that holds its first key (the gates above,
     the LSE within 1e-3), timed at the first beside the plain versions,
     SDPA (forward; its autograd backward alone, unpinned and pinned to each
     backend: the fastest backend's device ms is K6b's library_ms, null
     where the profiler recorded none) and the bound, K6's device and host
     time per call, plan and roofline share beside SDPA's as for K2, and
     K6b's device ms by launch (the split-key pass, the dQ combine) and
     plan; then five full-width steps of
     long-context captioning (`scripts/train_bench.py --long-context`:
     cap%tv, B = 2 samples of 32 frames, 8,224 condition tokens, a
     128-token caption; probability dropout 0, so attention stays on the
     kernels), each counted from 0 (K3 40, K4 40, K2 12, K6 12, K6b 12 per
     step), finite losses, the last below the second's, ms/step,
     samples/s, model TFLOP/s and peak memory; one no-grad forward of the
     same losses (K6 12, K6b 0); and BERT's gradients of the caption loss at
     B = 1 over condition tokens computed once, the bf16 kernel route
     against the card's fp32 plain route (loss within 2e-2 relative, cosine
     >= 0.99 per BERT parameter group and for the first and last layer's
     cross-attention q/k/v weights);
  9. mlp: P1 (`ops/fused_mlp.py`, the fused MLP of
     `scripts/pallas_matmul_probe.py`) against its plain version at the
     probe's geometry, x (28784, 1408), W1 (1408, 6144), W2 (6144, 1408),
     and at a ragged (200, 128) x (128, 256): x unit-std and the weights
     at 1/sqrt(fan-in), so the MLP branch is as large as x (the kernel
     gates, and the branch out - x alone under the relative mean gate);
     timed beside the plain version, the library route (torch.matmul,
     F.gelu, torch.matmul, the add; event and device ms) and the bound, with
     P1's device ms by launch (fc1 with the GELU epilogue, fc2 with the
     residual one);
     then the probe's chain of 8 calls (`scripts/torch_mlp_probe.py` at its
     0.02-scale data), counted from 0 (P1 8);
  9b. scst: K1's, K5's and K8's differentiated routes (autograd through
     the wrappers) at x (8, 257, 1408) 16 x 88 and (8, 257, 1792) 16 x
     112, bf16 on unit-std x: the output and every input's gradient
     against the card's fp32 plain autograd of the same composition under
     the relative mean gate, each call's launches held (K1 and K5: K3 1,
     then K4 1; K8: K8 1, then K3 1 and K4 1), timed beside the bf16 plain
     autograd; then `mico_tpu_torch.run.main` on configs/pretrain-omni.json
     (MiCo-g at full width) over an `annoindexed` corpus written to a
     temporary directory (64 clips of 8 JPEG frames with 2-3 reference
     captions, one corrupt clip), task `scst%tv` at B 64 x 8 frames (2056
     condition tokens), 40-token captions, 3 steps, no validation set,
     saves left out (phase run times them): each step counted from 0 (K1
     40, the rollout's ViT pass; nothing else), finite losses, BERT with a
     gradient and the vision tower without one, the seconds of each stage
     (rollout encoder, sample decode, greedy decode, reward, update,
     optimizer), the rewards, peak memory, and the last step under
     torch.profiler (the device alone: busy ms and the idle share); each
     sample's references also hold the model's own greedy caption, so
     that a random-weight model's advantages are not all 0. Then one
     `finetune_encoder=True` step at B 4 (K1 40, K3 40, K4 40; a vision
     gradient); the REINFORCE loss at B 2 with the tokens and advantages
     injected, the card in bf16 against the card in fp32 on the plain
     routes (loss within 2e-2, cosine >= 0.99 per optimizer group and for
     the first and last block's qkv_w); the recompute `generate_scst`
     under grad at B 4 over 2056 condition tokens on the cached route's
     tokens (K2 480, summed logp within 2e-2 of the cached route's, a
     gradient in every layer's cross-attention K weight); and one ViT-g
     training-route step at B 8 frames with no remat, a plain checkpoint,
     `save:attn_out` and `dots_with_no_batch_dims_saveable` (memory held
     for the backward, peak, K3/K4 launches, ms; gradient cosine >= 0.99
     per group against the run without remat, max |d|);
 10. run: `mico_tpu_torch.run.main` (the entry of `python -m
     mico_tpu_torch.run`) on `configs/pretrain-omni.json` at full width,
     ViT-g cut to 10 of its 40 blocks (`model_cfg.eva_override`), over an
     `annoindexed` corpus written to a temporary directory (32
     clips of 8 cv2 JPEG frames of 256 x 320 and a 5 s 16 kHz WAV, with
     captions, questions and answers, and one clip of corrupt JPEGs that
     the dataset resamples past), with CLI overrides: the data paths,
     `video_frame`, B 8, a `ret%tva` val set with the ITM re-rank on (its
     clips without the corrupt one: a dataset draws a corrupt clip's
     stand-in from its seeded RNG, so a run's later evaluations and a fresh
     testing run would score different galleries) and a `cap%tv` one (the
     corrupt clip kept), the shared tower's audio at 224 x 224. It trains 4 steps
     (`valid_freq` 1: evaluations and saves at steps 3 and 4), tests from
     that directory (`mode=testing`, `--pretrain_dir`: the same retrieval
     metrics as the step-4 evaluation within 1e-6), then checks resume at
     ViT-g width with 4 blocks (a 4-step run, then `resume=true` to step 6:
     it starts at 4, reloads the weights bitwise, and removes step 4's
     files only after step 6's are committed). Each stage is counted from
     0 and held to its own launches (K3 and K4 2 x blocks a train step; K1
     blocks x ViT passes and K2 12 x re-rank passes an evaluation; none in
     saves and loads), no plain twin may run on a card tensor, the losses
     are finite, retrieval metrics in [0, 1] and caption tokens in the
     vocabulary; it prints each stage's seconds (data wait and step, eval,
     save with the host RSS over it, load), the loader-fed step's cycle
     and the card's idle share in it (one step's device time under
     torch.profiler) beside phase train's synthetic step;
 11. captioner: the data half's captioners on VAST, the JAX package's
     default model (configs/default_model_cfg.json: ViT-g/14, BEATs AS2M,
     BERT-base) at full width, the ViT cut to 10 of its 40 blocks
     (`model_cfg.eva_override`), with random weights from seed 0:
     a native `.npz` pretrained directory written from the card
     (`log/hps.json`, `ckpt/model_step_1.npz`) and a corpus in a temporary
     directory (128 16 kHz WAVs of 30 s: 3 slices of 1024 x 64 fbank, 768
     condition tokens; 64 mp4s written by cv2, `mp4v`, 12 frames of 256 x
     320); one clip's BEATs tokens and its `EmbeddingPipeline.embed_audio`
     embedding, the card in bf16 against the port on the CPU in fp32
     (cosine >= 0.999 each), BEATs' forward ms at B 128 x 3 slices and its
     largest kernels by device time; then `mico_tpu_torch.run.main` on
     configs/caption-generation-audio.json (B 128) and -vision.json (B 64,
     8 frames, `video_rawvideo` through cv2) with `--pretrain_dir` and
     `run_cfg.generate_nums=3`, and a `ret%tva` evaluation with the ITM
     re-rank over vision + BEATs tokens (B 8), each evaluation counted from
     0 and held to its launches (K1 10 a ViT pass, K2 12 a re-rank pass,
     nothing else: K7 0; the audio captioner none), the annotation JSON (3
     captions a clip) and the tokens checked; the seconds of each
     evaluation split into the towers, the decode and the rest, captions/s,
     and the cv2 decode + preprocess of the 64 clips on one thread;
 12. dp (between run and captioner): data parallelism across processes.
     (a) `python -m torch.distributed.run --standalone --nproc_per_node 1
     -m mico_tpu_torch.run` with `run_cfg.multihost=true
     run_cfg.zero1=true` and the arguments and corpus of phase run's
     resume check (MiCo-g at full width with 4 blocks, B 8; NCCL at world
     1): 3 steps, evaluations and saves at steps 2 and 3 (the entry sets
     valid_steps from `valid_freq`, as JAX's does), rank 0's
     `log/record.json`; the step-1 losses within 2e-2 relative of that
     check's one-process run (the same seed, corpus, depth and draws), then
     a resume at world 1 without `multihost` (in this process) that starts
     at step 3 and takes step 4 (K3 8, K4 8); the steps' ms and peak memory
     beside that run's. (b) two ranks on the one card over gloo (NCCL refuses two ranks
     on one device), spawned once: rank 0 first takes the one-process step
     of ret%tva_cap%tva on the global batch of 4 (MiCo-g at full width,
     ViT cut to 10 of its 40 blocks for time, fp32 master weights, bf16
     compute, every rate 0, draws injected, Adam's eps 1e-3, no weight
     decay), then both ranks take the
     ZeRO-1 and the plain data-parallel step from the same weights on B 2
     each: every global loss and the gradient norm within 2e-2 relative of
     the reference's, the cosine of each optimizer group's parameter
     update to the reference's >= 0.99, each rank's step launching what
     the reference launched (K3 and K4 2 x blocks, K2 12 a BERT pass over
     the condition: rates 0 keep it off plain math); the peak memory per
     rank with and without ZeRO-1 and the collective seconds (gloo through
     the host, not an NCCL figure).
 13. tp (after dp): tensor and sequence parallelism, two ranks on the one
     card over gloo at data 1 x model 2: rank 0 first takes the
     one-process references on the whole models; then both ranks run the
     omni embeddings and ITM of MiCo-g (K1 10 a ViT pass) and of bigE at 4
     blocks (K5 4, K8's fp32 partial form 4 under `FUSED_ATTN_PROJ`)
     against them (cosine >= 0.999, ITM within 1e-2), the TP step of
     ret%tva_cap%tva (MiCo-g at full width, 10 ViT blocks, B 2, every rate
     0, draws injected; each loss within 2e-2 relative, each group's update
     cosine >= 0.99, K3 = K4 = 20 a rank, each rank's peak below the
     one-process step's) and its SP twin (losses within 2e-3 of TP's);
 14. pp (after tp): GPipe pipeline parallelism of the EVA tower, two ranks
     on the one card over gloo at data 1 x stages 2 (`pipeline_stages=2`):
     rank 0 first takes the one-process references on the whole model;
     then both ranks build MiCo-g at full width with 10 ViT blocks staged
     (5 a stage) from the same seed, run (b) the omni embeddings and ITM on
     the tower gathered whole (`whole_tower`; K1 10 a ViT pass; cosine >=
     0.999, ITM within 1e-2 of one process) and (a) the pipelined step of
     ret%tva_cap%tva at B 2 (every rate 0, draws injected): each loss
     within 2e-2 relative of the one-process step's, each optimizer
     group's update cosine >= 0.99, each rank's peak memory below the
     one-process step's, K3 = K4 = 5 x (M_vision + M_audio) a rank (a
     launch a block a microbatch; the auto M of 8 frames and of 4 audio
     slices), K2 the one-process step's and nothing else; it prints each
     rank's step seconds, the hops' seconds (gloo through the host, the
     wait for the other stage included: not an NCCL figure) and the
     bubble (S - 1) / (S + M - 1).
Each phase prints its wall time and the running total as it ends ([wall]
lines), and the total at the end.
The line before them is a JSON summary of the run, the second-to-last line
is {"kernels": [...]} with per-kernel numbers, and the last is
{"ok": true, "device": {...}}. Without CUDA it exits with code 2 and prints
no result.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the path whose own launch count the kernels line reports for each kernel
KERNEL_PATH = {"K1": "omni step", "K2": "ITM", "K3": "train step",
               "K4": "train step", "K5": "bigE omni step",
               "K6": "long-context train step",
               "K6b": "long-context train step",
               "K7": "int8 beam caption (image)",
               "K8": "bigE omni step (FUSED_ATTN_PROJ)",
               "K9": "CLIP omni step (PACKED_CLS_SPLIT)",
               "P1": "MLP probe chain"}
# published H100 SXM peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
RTOL = ATOL = 2e-2          # bf16 ulp is 2^-8; fp32 sums run in other orders
MEAN_ERR_MAX = 2e-3
# K3/K4: mean |d| against the reference's own mean magnitude (their outputs
# and gradients are far below the absolute gates at the train shape)
REL_MEAN_ERR_MAX = 1e-2
COSINE_MIN = 0.999          # the repo's embedding gate (BASELINE.md:23)
ITM_PROB_TOL = 1e-2
# bigE: the kernel route's ViT token error to fp32 against the bf16 plain
# route's (the ratio spans 0.95-1.03 over the omni batch's 16 images)
TOWER_ERR_RATIO = 1.05
S = 16                      # omni samples per step, as bench.py
TEXT_LEN = 30
NEW_TOKENS = 40             # caption length (MiCoConfig.max_caption_len)
MARGIN_MIN = 0.05           # fp32 top-1 margin above which tokens must agree
# the captioner deployment shape (scripts/decode_bench.py, preset vision)
DEPLOY_B, DEPLOY_COND = 64, 2056
# the demo phase: the ViT batches of its image, audio and video passes
DEMO_VIT_BATCHES = (1, 2, 4)
ZS_B = 16                   # the eva_clip phase's images (and RN50's)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card, by CUDA events over `iters` calls."""
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


def device_time_ms(fn, iters: int = 50, warmup: int = 3,
                   by_kernel: bool = False):
    """The device's own time per call (no host time, no gaps), from
    torch.profiler: for each kernel the calls ran, its mean recorded
    duration times its launches per call. The profiler now and then loses
    kernel records (a sixth of a kernel's, or nearly all of cuDNN's memset
    in one run: 3 of 50), so a sum over the calls divided by their number
    reads low. The calls are identical and follow a warm-up, so every kernel
    recorded runs in each of them: one recorded in fewer than half the calls
    counts once a call. None, logged, when no device kernel was recorded:
    a measurement the profiler could not take fails no check. With
    `by_kernel`, {kernel name: ms per call} instead of their sum."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels_us = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            per_call = round(evt.count / iters)
            if per_call < 1:
                log(f"  torch.profiler recorded {evt.key[:60]} {evt.count} "
                    f"times in {iters} calls; counted once a call")
                per_call = 1
            kernels_us[evt.key] = dev_us / evt.count * per_call
    if sum(kernels_us.values()) <= 0:
        log("  torch.profiler recorded no device kernel: device time not "
            "measured")
        return None
    if by_kernel:
        return {name: us / 1e3 for name, us in kernels_us.items()}
    return sum(kernels_us.values()) / 1e3


def host_time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """The host's time to issue one call: a loop with no synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * elapsed / iters


def split_timing(fa, fn, library, q, k, bms: float) -> dict:
    """K2's or K6's device and host time per call (no bias) beside SDPA's,
    the call's plan and the roofline share of its device time."""
    dev = device_time_ms(fn)
    _, kw, nsplit, _ = plan_of(fa, q, k)
    return dict(device_ms=dev, host_ms=host_time_ms(fn),
                library_device_ms=device_time_ms(library),
                library_host_ms=host_time_ms(library),
                splits=nsplit, key_warps=kw,
                roofline_share=None if dev is None else bms / dev)


def plan_of(fa, q, k, bias=None):
    """(row warps, key warps, splits, chunks a split) of K2/K6 on q, k."""
    rows = 0 if bias is None else (1 if bias.shape[2] == 1 else -1)
    return fa.flash_plan(q.shape[2], k.shape[2], q.shape[0] * q.shape[1],
                         q.shape[3], rows, fa._sm_count(q.device.index))


def k2_and_sdpa(fa, q, k, v):
    """K2 and one SDPA call on the same inputs (D 64), as closures."""
    import torch.nn.functional as F

    return (lambda: fa.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=0.125))


def plan_label(fa, q, k, bias=None) -> str:
    _, kw, nsplit, _ = plan_of(fa, q, k, bias)
    return f"{nsplit} split(s), {kw} key warp(s)"


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def finish_rows(rows: list, errs: dict) -> list:
    """Each kernel row gets the worst errors of its checks; its times are
    logged."""
    for row in rows:
        key = row["name"].split()[0]
        row["max_abs_err"] = max(e["max_abs_err"] for e in errs[key])
        row["mean_abs_err"] = max(e["mean_abs_err"] for e in errs[key])
        row["kernel_ms"] = row["ms"]
        log(f"  {row['name']}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
            f"library {ms_text(row['library_ms'])}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']})")
    return rows


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            rel_mean: float = 0.0) -> dict:
    """Holds got to want at RTOL/ATOL and mean |d| <= MEAN_ERR_MAX; with
    rel_mean also mean |d| <= rel_mean * mean |want|."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = {"max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item()}
    ref = want.float().abs()
    log(f"  {name}: max|d| {err['max_abs_err']:.3e}  "
        f"mean|d| {err['mean_abs_err']:.3e}  (|ref| max {ref.max().item():.3e}"
        f", mean {ref.mean().item():.3e})")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if err["mean_abs_err"] > MEAN_ERR_MAX:
        raise AssertionError(f"{name}: mean |d| {err['mean_abs_err']:.3e} "
                             f"> {MEAN_ERR_MAX}")
    if rel_mean and err["mean_abs_err"] > rel_mean * ref.mean().item():
        raise AssertionError(f"{name}: mean |d| {err['mean_abs_err']:.3e} "
                             f"> {rel_mean} * mean |ref| "
                             f"{ref.mean().item():.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def k1_inputs(gen, b, l=257, nh=16, d=88, dev="cuda"):
    """The projection at the model's init scale (std 0.02, as `MiCo`
    draws it): scores of std ~0.6, as the seeded main path gives K1."""
    w = nh * d

    def rnd(*shape, s=1.0, mean=0.0):
        return (mean + s * torch.randn(*shape, generator=gen)).to(dev)

    x = rnd(b, l, w).to(torch.bfloat16)
    g, b0 = rnd(w, s=0.1, mean=1.0), rnd(w, s=0.1)
    wq = rnd(w, 3 * w, s=0.02).to(torch.bfloat16)
    bias = rnd(3 * w, s=0.02)
    return x, g, b0, wq, bias, nh, d ** -0.5, 1e-6


def k1_library(x, g, b0, w, bias, nh, scale, eps, affine):
    """One PyTorch call per stage: F.layer_norm, torch.matmul, SDPA."""
    import torch.nn.functional as F

    b, l, wd = x.shape
    hd = w.shape[1] // 3                # all heads, or a rank's
    xn = F.layer_norm(x, (wd,), g.to(x.dtype) if affine else None,
                      b0.to(x.dtype) if affine else None, eps)
    qkv = torch.matmul(xn, w) + bias.to(x.dtype)
    q, k, v = qkv.view(b, l, 3, nh, hd // nh).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return o.transpose(1, 2).reshape(b, l, hd)


def k1_library_stages(x, g, b0, w, bias, nh, scale, eps) -> dict:
    """Device ms of K1's library route, stage by stage (affine on):
    F.layer_norm, F.linear at the qkv shape, SDPA on that qkv's heads."""
    import torch.nn.functional as F

    b, l, wd = x.shape
    gx, bx = g.to(x.dtype), b0.to(x.dtype)
    xn = F.layer_norm(x, (wd,), gx, bx, eps)
    wt, b16 = w.t(), bias.to(x.dtype)
    qkv = F.linear(xn, wt, b16)
    q, k, v = qkv.view(b, l, 3, nh, wd // nh).permute(2, 0, 3, 1, 4)
    return {"F.layer_norm": device_time_ms(
                lambda: F.layer_norm(x, (wd,), gx, bx, eps)),
            "F.linear": device_time_ms(lambda: F.linear(xn, wt, b16)),
            "SDPA": device_time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}


def itm_cross_qkv(gen, n=3, width=768, heads=12, enc_width=1408,
                  lq=TEXT_LEN, lk=257):
    """K2's inputs as BERT's cross-attention makes them: q from the text
    rows and k/v from one condition expanded to the n rows, each a
    (B, L, H, D) linear output viewed as (B, H, L, D). The defaults are
    ITM's (1 image x 3 captions over one ViT frame's 257 tokens)."""
    from mico_tpu_torch.ops.layers import linear

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).to("cuda",
                                                            torch.bfloat16)

    text, cond = r(n, lq, width), r(1, lk, enc_width).expand(n, -1, -1)
    wq = r(width, width, scale=width ** -0.5)
    wk, wv = (r(enc_width, width, scale=enc_width ** -0.5) for _ in range(2))
    d = width // heads
    q = linear(text, wq).reshape(n, lq, heads, d).transpose(1, 2)
    k, v = (linear(cond, w).reshape(n, lk, heads, d).transpose(1, 2)
            for w in (wk, wv))
    return q, k, v


def k7_inputs(gen, b, lq, lk, heads=12, width=768):
    """K7's inputs at a decode step: q (B, Lq, H) bf16 and cross K/V
    quantised by `quantize_kv`, K at twice V's spread (scores of std ~2)."""
    from mico_tpu_torch.ops.int8_attention import quantize_kv

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=gen)).cuda()

    q = r(b, lq, width).to(torch.bfloat16)
    k8, ks = quantize_kv(r(b, lk, width, scale=2.0), heads)
    v8, vs = quantize_kv(r(b, lk, width), heads)
    return q, k8, ks, v8, vs, heads


def k7_library(q, k8, ks, v8, vs, heads):
    """Dequantisation to bf16, then one SDPA call."""
    import torch.nn.functional as F

    b, lq, h = q.shape
    lk, d = k8.shape[1], h // heads

    def dq(x8, s):
        x = x8.view(b, lk, heads, d) * s[..., None]
        return x.to(torch.bfloat16).transpose(1, 2)

    o = F.scaled_dot_product_attention(
        q.view(b, lq, heads, d).transpose(1, 2), dq(k8, ks), dq(v8, vs),
        scale=d ** -0.5)
    return o.transpose(1, 2).reshape(b, lq, h)


def k7_library_stages(q, k8, ks, v8, vs, heads) -> dict:
    """Device ms of K7's library route, stage by stage: K and V dequantised
    to bf16, then SDPA on them."""
    import torch.nn.functional as F

    b, lq, h = q.shape
    lk, d = k8.shape[1], h // heads

    def dq(x8, s):
        x = x8.view(b, lk, heads, d) * s[..., None]
        return x.to(torch.bfloat16).transpose(1, 2)

    kd, vd = dq(k8, ks), dq(v8, vs)
    qh = q.view(b, lq, heads, d).transpose(1, 2)
    return {"dequant_k": device_time_ms(lambda: dq(k8, ks)),
            "dequant_v": device_time_ms(lambda: dq(v8, vs)),
            "sdpa": device_time_ms(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, scale=d ** -0.5))}


def phase_kernels(fa) -> list:
    from mico_tpu_torch.ops import int8_attention as i8

    gen = torch.Generator().manual_seed(1)
    errs = {"K1": [], "K2": [], "K7": []}
    log("phase kernels: K1 fused_ln_qkv_self_attention vs fused_ln_qkv_plain")
    # B = 8, a ragged width (W 80: two heads of 40, one 64-column k-step
    # past K), odd counts of k-steps (W 48 and 960: the GEMM's k-steps run
    # in pairs, so each ends on a step wholly past K), rows of three key
    # blocks (the attention's streamed path) and the bench ViT pass (16
    # samples x 7 frames), whose tensors are timed below
    for b, l, nh, d in ((8, 257, 16, 88), (2, 300, 2, 40), (2, 40, 2, 24),
                        (4, 257, 15, 64), (2, 600, 16, 88),
                        (S * 7, 257, 16, 88)):
        args = k1_inputs(gen, b, l, nh, d)
        for affine in (True, False):
            got = fa.fused_ln_qkv_self_attention(*args, affine)
            want = fa.fused_ln_qkv_plain(*args, affine)
            errs["K1"].append(compare(
                f"K1 ({b}, {l}, {nh * d}) H={nh} D={d} affine={affine}",
                got, want, rel_mean=REL_MEAN_ERR_MAX))
            del got, want
    k1_args = args
    # the demo's ViT passes (`mico_tpu_torch.inference_demo`): one image,
    # the audio's two slices and the video's four frames, unfolded (affine
    # on) as the demo runs them, and the EVA-CLIP image pass (phase
    # eva_clip: B 16, M = 4112 rows); 257 rows give the GEMM a ragged last
    # M-tile and the attention a grid of B x 16 blocks. A generator of
    # their own keeps the other cases' inputs as they were.
    demo_gen = torch.Generator().manual_seed(13)
    for what, b in ([("demo", b) for b in DEMO_VIT_BATCHES]
                    + [("eva_clip", ZS_B)]):
        args = k1_inputs(demo_gen, b)
        for affine in (True, False):
            errs["K1"].append(compare(
                f"K1 {what} ({b}, 257, 1408) H=16 D=88 affine={affine}",
                fa.fused_ln_qkv_self_attention(*args, affine),
                fa.fused_ln_qkv_plain(*args, affine),
                rel_mean=REL_MEAN_ERR_MAX))
    # the LayerNorm-prologue GEMM stage alone (statistics + GEMM,
    # `ln_gemm_bias`) at the timed shape
    x, g, b0, w, bias, _, _, eps = k1_args
    x2 = x.view(-1, x.shape[-1])
    for affine in (True, False):
        errs["K1"].append(compare(
            f"K1 GEMM stage, {tuple(x2.shape)} x {tuple(w.shape)} "
            f"affine={affine}",
            fa.ln_gemm_bias(x2, g, b0, w, bias, eps, affine),
            fa.ln_gemm_plain(x2, g, b0, w, bias, eps, affine),
            rel_mean=REL_MEAN_ERR_MAX))
    # K1 on a tensor-parallel rank's heads: x whole (the LN over all W),
    # w (W, 3·H·D) of rank 0's heads packed [q_h | k_h | v_h]
    tp_gen = torch.Generator().manual_seed(19)
    k1_rank = {}
    for b, l, nh, d, model in TP_RANK_SHAPES["K1"]:
        x, g, b0, w, bias, _, scale, eps = k1_inputs(tp_gen, b, l, nh, d)
        args = (x, g, b0, rank_part(w, ("qkv", 1), model),
                rank_part(bias, ("qkv", 0), model), nh // model, scale, eps)
        del w, bias
        for affine in (True, False):
            errs["K1"].append(compare(
                f"K1 rank ({b}, {l}, {nh * d}) -> {nh // model * d} of "
                f"{nh * d} (model {model}, H={nh // model} D={d}) "
                f"affine={affine}",
                fa.fused_ln_qkv_self_attention(*args, affine),
                fa.fused_ln_qkv_plain(*args, affine),
                rel_mean=REL_MEAN_ERR_MAX))
        k1_rank.setdefault("args", (args, model))

    log("phase kernels: K2 flash_attention vs flash_attention_plain")

    def qkv(b, h, lq, lk, d=64):
        def r(*s):
            return torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
        return r(b, h, lq, d), r(b, h, lk, d), r(b, h, lk, d)

    itm_qkv = itm_cross_qkv(gen)
    # the recompute caption decode of a 4-frame video: the 10-row buffer
    # (8 new tokens) over 4 x 257 condition tokens of width 768
    dec_qkv = itm_cross_qkv(gen, n=1, enc_width=768, lq=10, lk=1028)
    cases = [("no bias, ITM layout: q (3,12,30,64), k/v (3,12,257,64) "
              "strided views of (3,L,12,64)", itm_qkv, None),
             ("no bias, recompute decode layout: q (1,12,10,64), k/v "
              "(1,12,1028,64) strided views of (1,L,12,64)", dec_qkv, None)]
    for lk in (257, 1028):
        cases.append((f"no bias q (4,12,30,64) kv (4,12,{lk},64)",
                      qkv(4, 12, 30, lk), None))
    pad = torch.ones(4, 70)
    pad[1, 50:] = 0
    pad[3, 20:] = 0
    cases.append(("bias (4,1,1,70) padding mask, L = 70", qkv(4, 12, 70, 70),
                  ((1.0 - pad) * -10000.0)[:, None, None, :].cuda()))
    full = (torch.rand(4, 30, 257, generator=gen) > 0.3).float()
    full[:, :, 0] = 1
    cases.append(("bias (4,1,30,257) mask", qkv(4, 12, 30, 257),
                  ((1.0 - full) * -10000.0)[:, None].cuda()))
    # cases that cross split boundaries of the keys: one query row, the
    # long ends of the resident route (a ragged last split at 8100 = 126 x
    # 64 + 36), the decode with a padding bias that masks every key of its
    # second split, and the long-context step's causal self-attention
    cases.append(("Lq = 1: q (2,12,1,64) kv (2,12,1028,64)",
                  qkv(2, 12, 1, 1028), None))
    cases.append(("q (1,12,30,64) kv (1,12,8192,64)", qkv(1, 12, 30, 8192),
                  None))
    cases.append(("ragged q (1,4,40,64) kv (1,4,8100,64)", qkv(1, 4, 40, 8100),
                  None))
    q, k, v = qkv(1, 12, 10, 1028)
    _, _, nsplit, per = plan_of(fa, q, k)
    pad = torch.ones(1, 1028)
    pad[:, 64 * per:128 * per] = 0
    pad[:, 1000:] = 0
    cases.append((f"bias (1,1,1,1028) masking all of split 2 of {nsplit} "
                  f"(keys {64 * per}..{128 * per - 1}), q (1,12,10,64)",
                  (q, k, v), ((1.0 - pad) * -10000.0)[:, None, None].cuda()))
    causal = torch.full((128, 128), -10000.0).triu(1).expand(2, 1, 128, 128)
    cases.append(("causal (2,1,128,128) bias, (2,12,128,64) self-attention",
                  qkv(2, 12, 128, 128), causal.contiguous().cuda()))
    # the demo's ITM: one image against its two captions, the condition's
    # 257 tokens of width 768 expanded to both rows; the path passes no
    # bias (the cross-attention has no encoder mask), the second case a
    # key-padding bias
    demo_qkv = itm_cross_qkv(demo_gen, n=2, enc_width=768)
    cases.append(("demo ITM layout: q (2,12,30,64), k/v (2,12,257,64) "
                  "strided views of (2,L,12,64), no bias", demo_qkv, None))
    pad = torch.ones(2, 257)
    pad[1, 200:] = 0
    cases.append(("demo ITM layout with a (2,1,1,257) padding bias", demo_qkv,
                  ((1.0 - pad) * -10000.0)[:, None, None].cuda()))
    for name, (q, k, v), bias in cases:
        got = fa.flash_attention(q, k, v, bias=bias)
        want = fa.flash_attention_plain(q, k, v, bias, q.shape[-1] ** -0.5)
        errs["K2"].append(compare(
            f"K2 {name}, {plan_label(fa, q, k, bias)}", got, want))
    if plan_of(fa, *dec_qkv[:2])[2] < 2:
        raise AssertionError("K2's decode shape takes one split: the masked "
                             "split case checks nothing")
    vit_cases = phase_k2_vit(fa, gen, errs)

    log("phase kernels: K7 int8_cross_attention vs int8_cross_attention_plain")
    # beam vision (64 x 3 beams over 8 frames), greedy vision, audio beam
    # (128 x 2 slices), one caption of a 4-frame video (the first is timed);
    # one query row, the n16 tile (Lq 9 and 16), fewer items than SMs, a
    # ragged Lk of one frame; the large plan by Lk and by head count
    sms = fa._sm_count(0)
    routes = set()
    for b, lq, lk, heads, what in (
            (64, 6, 2056, 12, "beam vision"),
            (64, 2, 2056, 12, "greedy vision"),
            (128, 6, 514, 12, "audio beam"),
            (1, 6, 1028, 12, "one 4-frame video caption"),
            (64, 1, 2056, 12, "one query row"),
            (64, 9, 2056, 12, "Lq 9"),
            (64, 16, 2056, 12, "Lq 16"),
            (8, 6, 2056, 12, "B 8, 96 items"),
            (3, 6, 257, 12, "B 3 over one frame"),
            (4, 6, 9108, 12, "Lk 9108"),
            (2, 6, 1028, 6, "6 heads")):
        args = k7_inputs(gen, b, lq, lk, heads, 64 * heads)
        plan = i8.k7_plan(b, heads, lq, lk, sms)
        routes.add(plan.route)
        got = i8.int8_cross_attention(*args)
        want = i8.int8_cross_attention_plain(*args, 0.125)
        errs["K7"].append(compare(
            f"K7 {what}: q ({b}, {lq}, {64 * heads}), K/V ({b}, {lk}, "
            f"{64 * heads}) int8, {plan.route} plan ({plan.ctas} CTAs, "
            f"n{plan.n_tile}, {plan.stages} stages)", got, want,
            rel_mean=REL_MEAN_ERR_MAX))
        if b == 64 and lq == 6:
            k7_args = args
        del got, want, args
    if routes != {"fast", "large"}:
        raise AssertionError(f"K7's cases launched only the {routes} plan")

    log("phase kernels: times at the main path's shapes")
    rows = []
    # K1 at the bench ViT pass: 16 samples x 7 frames, affine (unfolded) as
    # the omni step runs it; affine off is the folded serving route
    args = k1_args
    x, g, b0, w, bias, nh, scale, eps = args
    b, l, wd = x.shape
    d = wd // nh
    flops = 2 * b * l * wd * 3 * wd + 4 * b * nh * l * l * d
    nbytes = 2 * (2 * x.numel() + w.numel()) + 4 * (bias.numel() + 2 * wd)
    bms, by = bound_ms(flops, nbytes)

    def k1():
        return fa.fused_ln_qkv_self_attention(*args, True)

    stages = stage_device_ms(k1, {"statistics": "stats", "GEMM": "gemm",
                                  "attention": "attn"})
    k1_lib = k1_library_stages(*args)
    log("  K1 device ms by stage: " + ", ".join(
        f"{k} {ms_text(v)}" for k, v in stages.items()) + "; beside: "
        + ", ".join(f"{k} {ms_text(v)}" for k, v in k1_lib.items()))
    rows.append(dict(
        name="K1 fused_ln_qkv_self_attention", route="cuda",
        source="mico_tpu_torch/csrc/fused_ln_qkv_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:1624",
        shape=f"x ({b}, {l}, {wd}) bf16, W ({wd}, {3 * wd}), H={nh}, D={d}",
        ms=cuda_time_ms(k1),
        ms_affine_off=cuda_time_ms(
            lambda: fa.fused_ln_qkv_self_attention(*args, False)),
        plain_ms=cuda_time_ms(lambda: fa.fused_ln_qkv_plain(*args, True),
                              iters=5, warmup=1),
        library_ms=cuda_time_ms(lambda: k1_library(*args, True)),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        device_ms=device_time_ms(k1), stages_device_ms=stages,
        library_stages_device_ms=k1_lib,
    ))
    # ... and at a model-2 rank's heads of the same pass
    args, model = k1_rank["args"]
    x, g, b0, w, bias, nh, scale, eps = args
    hd = w.shape[1] // 3
    rows.append(rank_row(
        f"K1 fused_ln_qkv_self_attention rank (model {model})",
        "mico_tpu_torch/csrc/fused_ln_qkv_attn.cu",
        "mico_tpu/ops/flash_attention.py:1624",
        f"x ({b}, {l}, {wd}) bf16, W ({wd}, {3 * hd}) of a rank's "
        f"[q_h | k_h | v_h], H={nh}, D={d}",
        lambda: fa.fused_ln_qkv_self_attention(*args, True),
        lambda: fa.fused_ln_qkv_plain(*args, True),
        lambda: k1_library(*args, True),
        2 * b * l * wd * 3 * hd + 4 * b * nh * l * l * d,
        2 * (x.numel() + b * l * hd + w.numel())
        + 4 * (bias.numel() + 2 * wd)))
    # K2 at the ITM cross-attention: 1 image x 3 captions, compared above
    q, k, v = itm_qkv
    flops = 4 * q.shape[0] * 12 * TEXT_LEN * 257 * 64
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bms, by = bound_ms(flops, nbytes)
    k2, sdpa = k2_and_sdpa(fa, q, k, v)
    rows.append(dict(
        name="K2 flash_attention", route="cuda",
        source="mico_tpu_torch/csrc/flash_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:93",
        shape="q (3, 12, 30, 64), k/v (3, 12, 257, 64) bf16 strided views "
              "of (3, L, 12, 64), no bias",
        ms=cuda_time_ms(k2),
        plain_ms=cuda_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, None, 0.125)),
        library_ms=cuda_time_ms(sdpa),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        **split_timing(fa, k2, sdpa, q, k, bms),
    ))
    # ... at the EVA02-L ViT pass's self-attention, with and without the
    # relative bias (compared in `phase_k2_vit`)
    rows[-1].update(k2_vit_timing(fa, vit_cases))
    # ... and at the recompute caption decode's cross-attention
    q, k, v = dec_qkv
    k2, sdpa = k2_and_sdpa(fa, q, k, v)
    dbms, dby = bound_ms(4 * 12 * 10 * 1028 * 64,
                         2 * (2 * q.numel() + k.numel() + v.numel()))
    rows[-1].update(
        decode_shape="q (1, 12, 10, 64), k/v (1, 12, 1028, 64) bf16 strided "
                     "views of (1, L, 12, 64), no bias",
        decode_ms=cuda_time_ms(k2),
        decode_plain_ms=cuda_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, None, 0.125)),
        decode_library_ms=cuda_time_ms(sdpa),
        decode_bound_ms=dbms, decode_bound_by=dby,
        **{f"decode_{key}": val for key, val in split_timing(
            fa, k2, sdpa, q, k, dbms).items()})
    # K7 at the beam vision decode step: bytes are the int8 K/V, the scales,
    # q and the output; operations the two products
    q, k8, ks, v8, vs, heads = k7_args
    b, lq, h = q.shape
    lk = k8.shape[1]
    flops = 4 * b * lq * lk * h
    nbytes = (k8.numel() + v8.numel() + 4 * (ks.numel() + vs.numel())
              + 2 * 2 * q.numel())
    bms, by = bound_ms(flops, nbytes)

    def k7():
        return i8.int8_cross_attention(*k7_args)

    dev = device_time_ms(k7)
    rows.append(dict(
        name="K7 int8_cross_attention", route="cuda",
        source="mico_tpu_torch/csrc/int8_cross_attn.cu",
        replaces="mico_tpu/ops/int8_attention.py:86",
        shape=f"q ({b}, {lq}, {h}) bf16, K/V ({b}, {lk}, {h}) int8, "
              f"scales ({b}, {lk}, {heads}) fp32",
        ms=cuda_time_ms(k7),
        plain_ms=cuda_time_ms(
            lambda: i8.int8_cross_attention_plain(*k7_args, 0.125),
            iters=5, warmup=1),
        library_ms=cuda_time_ms(lambda: k7_library(*k7_args)),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        device_ms=dev, host_ms=host_time_ms(k7),
        plan=i8.k7_plan(b, heads, lq, lk, sms)._asdict(),
        roofline_share=None if dev is None else bms / dev,
        library_stages_device_ms=k7_library_stages(*k7_args),
    ))
    finish_rows(rows, errs)
    log(f"  {rows[0]['name']} affine=False: {rows[0]['ms_affine_off']:.4f} ms")
    row = rows[2]
    log(f"  {row['name']} at the recompute decode: {row['decode_ms']:.4f} ms "
        f"(plain {row['decode_plain_ms']:.4f}, library "
        f"{row['decode_library_ms']:.4f}, bound {row['decode_bound_ms']:.4f})")
    for pre, what in (("", "ITM"), ("decode_", "recompute decode")):
        log_split_timing(f"{row['name']} at {what}", row, pre)
    log(f"  {row['name']} at the EVA02-L ViT pass {row['vit_shape']}: "
        f"{row['vit_ms']:.4f} ms (device {ms_text(row['vit_device_ms'])}; "
        f"plain {row['vit_plain_ms']:.4f}; SDPA {row['vit_library_ms']:.4f}, "
        f"device {ms_text(row['vit_library_device_ms'])}; bound "
        f"{row['vit_bound_ms']:.4f} by {row['vit_bound_by']}); with the "
        f"(1, 16, 257, 257) relative bias {row['vit_bias_ms']:.4f} ms "
        f"(device {ms_text(row['vit_bias_device_ms'])}; SDPA with the bias "
        f"as a float mask {row['vit_bias_library_ms']:.4f}, device "
        f"{ms_text(row['vit_bias_library_device_ms'])}; bound "
        f"{row['vit_bias_bound_ms']:.4f}); plan {row['vit_plan']}")
    row = rows[3]
    log(f"  {row['name']} at the beam decode step: device "
        f"{ms_text(row['device_ms'])} ms, host {row['host_ms']:.4f} ms a "
        f"call, plan {row['plan']}, roofline share "
        f"{ms_text(row['roofline_share'], 3)}; library route device "
        + ", ".join(f"{k} {ms_text(v)}"
                    for k, v in row['library_stages_device_ms'].items()))
    return rows


# K2 as the EVA02 towers' self-attention: (B, H, L) of EVA02-L's bench pass
# (16 samples x 7 frames), of EVA02-L-336 at 16 frames and of EVA02-B
K2_VIT_SHAPES = ((S * 7, 16, 257), (16, 16, 577), (16, 12, 197))


def vit_qkv(gen, b, h, l, d=64):
    """Unit-std bf16 q, k, v (B, H, L, D) as the EVA02 block hands them to
    K2: q and k the contiguous RoPE outputs, v a strided view of the
    (B, L, 3·H·D) qkv product."""
    def r(*s):
        return torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
    qkv = r(b, l, 3 * h * d).view(b, l, 3, h, d)
    return r(b, h, l, d), r(b, h, l, d), qkv[:, :, 2].transpose(1, 2)


def flash_plan_text(fa, q, k, bias=None) -> str:
    rw, kw, nsplit, per = plan_of(fa, q, k, bias)
    return (f"{rw} row warp(s), {kw} key warp(s), {nsplit} split(s) of "
            f"{per} chunk(s)")


def phase_k2_vit(fa, gen, errs) -> dict:
    """K2 against its plain version at the EVA02 towers' self-attention
    (Lq = Lk, D 64, v a strided view), the bench pass also with a (1, H, L,
    L) fp32 relative bias, under the K2 gates and mean |d| <= 1e-2 * mean
    |ref|; returns the bench pass's inputs for timing."""
    log("phase kernels: K2 as ViT self-attention (EVA02-L, -L-336, -B)")
    out = {}
    for b, h, l in K2_VIT_SHAPES:
        q, k, v = vit_qkv(gen, b, h, l)
        biases = [None]
        if (b, h, l) == K2_VIT_SHAPES[0]:
            biases.append(torch.randn(1, h, l, l, generator=gen).cuda())
            out = dict(qkv=(q, k, v), bias=biases[1])
        for bias in biases:
            got = fa.flash_attention(q, k, v, bias=bias)
            want = fa.flash_attention_plain(q, k, v, bias, 0.125)
            what = "no bias" if bias is None else f"bias {tuple(bias.shape)}"
            errs["K2"].append(compare(
                f"K2 ViT q/k/v ({b}, {h}, {l}, 64), v strided, {what}; "
                f"{flash_plan_text(fa, q, k, bias)}", got, want,
                rel_mean=REL_MEAN_ERR_MAX))
            del got, want
        if (b, h, l) != K2_VIT_SHAPES[0]:
            del q, k, v
    return out


def k2_vit_timing(fa, cases: dict) -> dict:
    """K2's event and device ms at the EVA02-L bench pass beside its plain
    version, SDPA (the bias as a float mask) and the bound: each input read
    once and the output written once, and 4·B·H·L²·D operations."""
    import torch.nn.functional as F

    q, k, v = cases["qkv"]
    bias = cases["bias"]
    b, h, l, d = q.shape
    flops = 4 * b * h * l * l * d
    nbytes = 2 * 4 * q.numel()
    bms, by = bound_ms(flops, nbytes)
    bbms, _ = bound_ms(flops, nbytes + 4 * bias.numel())
    res = dict(vit_shape=f"q/k/v ({b}, {h}, {l}, {d}) bf16, v a strided view "
                         f"of ({b}, {l}, {3 * h * d})",
               vit_bound_ms=bms, vit_bound_by=by, vit_flops=flops,
               vit_bytes=nbytes, vit_bias_bound_ms=bbms,
               vit_plan=flash_plan_text(fa, q, k),
               vit_bias_plan=flash_plan_text(fa, q, k, bias))
    for pre, bb in (("vit_", None), ("vit_bias_", bias)):
        k2 = functools.partial(fa.flash_attention, q, k, v, bias=bb)
        sdpa = functools.partial(F.scaled_dot_product_attention, q, k, v,
                                 attn_mask=None if bb is None
                                 else bb.to(torch.bfloat16), scale=0.125)
        res.update({
            f"{pre}ms": cuda_time_ms(k2),
            f"{pre}device_ms": device_time_ms(k2, iters=20),
            f"{pre}plain_ms": cuda_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, bb, 0.125), iters=5, warmup=1),
            f"{pre}library_ms": cuda_time_ms(sdpa),
            f"{pre}library_device_ms": device_time_ms(sdpa, iters=20)})
    return res


def ms_text(x, digits: int = 4) -> str:
    """A measured number, or "not measured" where the profiler gave none."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def log_split_timing(what: str, row: dict, pre: str = "") -> None:
    log(f"  {what}: device {ms_text(row[pre + 'device_ms'])} ms, host "
        f"{row[pre + 'host_ms']:.4f} ms a call, {row[pre + 'splits']} "
        f"split(s), {row[pre + 'key_warps']} key warp(s), roofline share "
        f"{ms_text(row[pre + 'roofline_share'], 3)}; SDPA "
        f"device {ms_text(row[pre + 'library_device_ms'])}, host "
        f"{row[pre + 'library_host_ms']:.4f}")


# ---------------------------------------------------------------------------
# phase 2b: K5 and K8, the post-norm block's projection-fused attention
# ---------------------------------------------------------------------------


def fused_qkv_inputs(gen, b, l, nh, d):
    """x of unit std and the projections at the model's init std 0.02 (the
    biases too, so that they are not trivially zero): scaled scores of std
    ~0.7, as the seeded bigE tower gives K5."""
    w = nh * d

    def rnd(*shape, s=1.0, dtype=torch.bfloat16):
        return (s * torch.randn(*shape, generator=gen)).to("cuda", dtype)

    return dict(x=rnd(b, l, w), w=rnd(w, 3 * w, s=0.02),
                bias=rnd(3 * w, s=0.02, dtype=torch.float32),
                wp=rnd(w, w, s=0.02), bp=rnd(w, s=0.02, dtype=torch.float32),
                num_heads=nh, scale=d ** -0.5)


def k5_args(a: dict) -> tuple:
    return a["x"], a["w"], a["bias"], a["num_heads"], a["scale"]


def k8_args(a: dict) -> tuple:
    return (a["x"], a["w"], a["bias"], a["wp"], a["bp"], a["num_heads"],
            a["scale"])


def k5_library(x, w, bias, nh, scale):
    """F.linear for the projection, then one SDPA call."""
    import torch.nn.functional as F

    b, l, wd = x.shape
    hd = w.shape[1] // 3                # all heads, or a rank's
    qkv = F.linear(x, w.t(), bias.to(x.dtype))
    q, k, v = qkv.view(b, l, 3, nh, hd // nh).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return o.transpose(1, 2).reshape(b, l, hd)


def k8_library(x, w, bias, wp, bp, nh, scale):
    import torch.nn.functional as F

    return F.linear(k5_library(x, w, bias, nh, scale), wp.t(), bp.to(x.dtype))


def k8_partial_library(x, w, bias, wp, nh, scale):
    """K8's partial form by the library: K5's, then one fp32-output product
    (the bf16 product in fp32 accumulation, cast; no bias)."""
    return torch.matmul(k5_library(x, w, bias, nh, scale), wp).float()


# the model-axis sizes whose rank shapes the kernels are held at: ViT-g's
# 16 heads of 88 (K1; K5 in the recomputed inference route) and bigE's 16
# of 112 (K5, K8) over 2 and 4 ranks
TP_RANK_SHAPES = {"K1": ((S * 7, 257, 16, 88, 2), (8, 257, 16, 88, 4)),
                  "K5": ((S * 7, 257, 16, 112, 2), (8, 257, 16, 88, 4),
                         (3, 50, 4, 64, 2)),
                  "K8": ((S * 7, 257, 16, 112, 2), (3, 50, 4, 64, 2))}


def rank_part(t: torch.Tensor, split, model: int, index: int = 0):
    """Rank `index`'s part of a whole tensor over `model` ranks, as the
    sharded model holds it (`tensor_parallel.shard`), contiguous."""
    from mico_tpu_torch.parallel.tensor_parallel import ModelAxis, shard

    return shard(t, split, ModelAxis(None, model, index)).contiguous()


def rank_row(name: str, source: str, replaces: str, shape: str, fn, plain,
             library, flops: float, nbytes: float) -> dict:
    """A kernel line's row at a rank's shape: ms, plain, library and device
    ms beside the bound at that shape."""
    bms, by = bound_ms(flops, nbytes)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                shape=shape, ms=cuda_time_ms(fn),
                plain_ms=cuda_time_ms(plain, iters=5, warmup=1),
                library_ms=cuda_time_ms(library), bound_ms=bms, bound_by=by,
                flops=flops, bytes=nbytes, device_ms=device_time_ms(fn))


def stage_device_ms(fn, stages=None) -> dict:
    """Device ms per call of each stage of a K1/K5/K8 call (torch.profiler,
    by kernel name: `stages` maps a stage to a word of its kernels' names,
    by default the GEMM's launches, summed, and the attention's), or None
    where the profiler recorded nothing."""
    stages = stages or {"gemm": "gemm", "attention": "attn"}
    kern = device_time_ms(fn, by_kernel=True)
    if kern is None:
        return {stage: None for stage in stages}
    return {stage: sum(ms for n, ms in kern.items() if word in n)
            for stage, word in stages.items()}


def phase_fused_qkv_kernels(fa) -> list:
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(4)
    errs = {"K5": [], "K8": []}
    log("phase kernels: K5 fused_qkv_self_attention / K8 fused_qkv_attn_proj "
        "vs fused_qkv_plain / fused_qkv_attn_proj_plain")
    # the bigE ViT pass (16 samples x 7 frames; the tensors timed below),
    # ViT-g's head dim 88, a ragged tail at 4 x 64, and rows of three key
    # blocks (the attention's streamed path past 272 keys)
    for b, l, nh, d in ((S * 7, 257, 16, 112), (8, 257, 16, 88),
                        (3, 50, 4, 64), (2, 600, 16, 112)):
        a = fused_qkv_inputs(gen, b, l, nh, d)
        what = f"({b}, {l}, {nh * d}) H={nh} D={d}"
        errs["K5"].append(compare(
            f"K5 {what}", fa.fused_qkv_self_attention(*k5_args(a)),
            fa.fused_qkv_plain(*k5_args(a)), rel_mean=REL_MEAN_ERR_MAX))
        errs["K8"].append(compare(
            f"K8 {what}", fa.fused_qkv_attn_proj(*k8_args(a)),
            fa.fused_qkv_attn_proj_plain(*k8_args(a)),
            rel_mean=REL_MEAN_ERR_MAX))
        if b == S * 7:
            timed = a
        elif d == 64:
            ragged = a
    # K5 and K8 on a tensor-parallel rank's heads: x whole, w (W, 3·H·D)
    # of rank 0's heads, wp its (H·D, W) rows; K8's partial form (the fp32
    # product before bp, which the ranks sum) against its plain version
    tp_gen = torch.Generator().manual_seed(23)
    rank_args = {}
    for kernel in ("K5", "K8"):
        for b, l, nh, d, model in TP_RANK_SHAPES[kernel]:
            r = fused_qkv_inputs(tp_gen, b, l, nh, d)
            r.update(w=rank_part(r["w"], ("qkv", 1), model),
                     bias=rank_part(r["bias"], ("qkv", 0), model),
                     wp=rank_part(r["wp"], ("block", 0), model),
                     num_heads=nh // model)
            what = (f"rank ({b}, {l}, {nh * d}) -> {nh // model * d} "
                    f"(model {model}, H={nh // model} D={d})")
            if kernel == "K5":
                got = fa.fused_qkv_self_attention(*k5_args(r))
                want = fa.fused_qkv_plain(*k5_args(r))
            else:
                got = fa.fused_qkv_attn_proj(*k8_args(r), partial=True)
                want = fa.fused_qkv_attn_proj_plain(*k8_args(r),
                                                    partial=True)
                if got.dtype != torch.float32:
                    raise AssertionError(f"K8 partial: {got.dtype}")
                what += " fp32 partial, before bp"
            errs[kernel].append(compare(f"{kernel} {what}", got, want,
                                        rel_mean=REL_MEAN_ERR_MAX))
            rank_args.setdefault(kernel, (r, model))
            del got, want
    a = timed
    b, l, wd = a["x"].shape
    nh = a["num_heads"]
    d = wd // nh
    m = b * l
    x2 = a["x"].view(m, wd)
    # the GEMM stage alone (mico_bf16_gemm_bias) against its plain product,
    # at the qkv and the out-projection shape and the ragged tail's qkv
    gemm_errs = {}
    r2 = ragged["x"].view(-1, ragged["x"].shape[-1])
    for what, args in (("qkv", (x2, a["w"], a["bias"])),
                       ("out-projection", (x2, a["wp"], a["bp"])),
                       ("ragged qkv", (r2, ragged["w"], ragged["bias"]))):
        shape = f"({args[0].shape[0]}, {args[0].shape[1]}) x {tuple(args[1].shape)}"
        err = compare(f"GEMM stage {what} {shape}", fa.bf16_gemm_bias(*args),
                      fa.bf16_gemm_plain(*args), rel_mean=REL_MEAN_ERR_MAX)
        gemm_errs[what] = err
    shape = f"x ({b}, {l}, {wd}) bf16, W ({wd}, {3 * wd}), H={nh}, D={d}"
    flops = 2 * b * l * wd * 3 * wd + 4 * b * nh * l * l * d
    nbytes = 2 * (2 * a["x"].numel() + a["w"].numel()) + 4 * a["bias"].numel()

    def k5():
        return fa.fused_qkv_self_attention(*k5_args(a))

    def k8():
        return fa.fused_qkv_attn_proj(*k8_args(a))

    # the stages' yardsticks: one F.linear at each GEMM's shape and one SDPA
    # call on the q/k/v of the same projection (times only)
    qkv = F.linear(x2, a["w"].t(), a["bias"].to(x2.dtype))
    q, k, v = qkv.view(b, l, 3, nh, d).permute(2, 0, 3, 1, 4)
    o = k5().view(m, wd)
    wt, wpt = a["w"].t(), a["wp"].t()
    b16, bp16 = a["bias"].to(x2.dtype), a["bp"].to(x2.dtype)
    library_stages = {
        "qkv GEMM (F.linear)": device_time_ms(lambda: F.linear(x2, wt, b16)),
        "attention (SDPA)": device_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=a["scale"])),
        "out-projection GEMM (F.linear)": device_time_ms(
            lambda: F.linear(o, wpt, bp16))}
    st5, st8 = stage_device_ms(k5), stage_device_ms(k8)
    stages5 = {"qkv GEMM": st5["gemm"], "attention": st5["attention"]}
    stages8 = {"qkv GEMM": st5["gemm"], "attention": st8["attention"],
               "out-projection GEMM": None if None in (st8["gemm"], st5["gemm"])
               else st8["gemm"] - st5["gemm"]}
    for name, stages in (("K5", stages5), ("K8", stages8)):
        log(f"  {name} device ms by stage: " + ", ".join(
            f"{k} {ms_text(v)}" for k, v in stages.items()) + "; beside: "
            + ", ".join(f"{k} {ms_text(v)}" for k, v in library_stages.items()))
    rows = []
    bms, by = bound_ms(flops, nbytes)
    rows.append(dict(
        name="K5 fused_qkv_self_attention", route="cuda",
        source="mico_tpu_torch/csrc/fused_qkv_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:1277", shape=shape,
        ms=cuda_time_ms(k5),
        plain_ms=cuda_time_ms(lambda: fa.fused_qkv_plain(*k5_args(a)),
                              iters=5, warmup=1),
        library_ms=cuda_time_ms(lambda: k5_library(*k5_args(a))),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        device_ms=device_time_ms(k5), stages_device_ms=stages5,
        library_stages_device_ms=library_stages,
        gemm_stage_checks=gemm_errs))
    flops += 2 * b * l * wd * wd
    nbytes += 2 * a["wp"].numel() + 4 * a["bp"].numel()
    bms, by = bound_ms(flops, nbytes)
    rows.append(dict(
        name="K8 fused_qkv_attn_proj", route="cuda",
        source="mico_tpu_torch/csrc/fused_qkv_attn_proj.cu",
        replaces="mico_tpu/ops/flash_attention.py:1443",
        shape=shape + f", Wp ({wd}, {wd})",
        ms=cuda_time_ms(k8),
        plain_ms=cuda_time_ms(lambda: fa.fused_qkv_attn_proj_plain(
            *k8_args(a)), iters=5, warmup=1),
        library_ms=cuda_time_ms(lambda: k8_library(*k8_args(a))),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        device_ms=device_time_ms(k8), stages_device_ms=stages8,
        library_stages_device_ms=library_stages))
    # ... and at a model-2 rank's heads of the same pass
    for kernel in ("K5", "K8"):
        r, model = rank_args[kernel]
        hd, nh_r = r["w"].shape[1] // 3, r["num_heads"]
        flops = 2 * b * l * wd * 3 * hd + 4 * b * nh_r * l * l * d
        nbytes = (2 * (r["x"].numel() + r["w"].numel())
                  + 4 * r["bias"].numel())
        shape = (f"x ({b}, {l}, {wd}) bf16, W ({wd}, {3 * hd}) of a rank's "
                 f"[q_h | k_h | v_h], H={nh_r}, D={d}")
        if kernel == "K5":
            rows.append(rank_row(
                f"K5 fused_qkv_self_attention rank (model {model})",
                "mico_tpu_torch/csrc/fused_qkv_attn.cu",
                "mico_tpu/ops/flash_attention.py:1277", shape,
                lambda r=r: fa.fused_qkv_self_attention(*k5_args(r)),
                lambda r=r: fa.fused_qkv_plain(*k5_args(r)),
                lambda r=r: k5_library(*k5_args(r)),
                flops, nbytes + 2 * b * l * hd))
        else:
            rows.append(rank_row(
                f"K8 fused_qkv_attn_proj rank (model {model}, fp32 partial)",
                "mico_tpu_torch/csrc/fused_qkv_attn_proj.cu",
                "mico_tpu/ops/flash_attention.py:1443",
                shape + f", Wp ({hd}, {wd}) rows, out fp32 without bp",
                lambda r=r: fa.fused_qkv_attn_proj(*k8_args(r),
                                                   partial=True),
                lambda r=r: fa.fused_qkv_attn_proj_plain(*k8_args(r),
                                                         partial=True),
                lambda r=r: k8_partial_library(
                    r["x"], r["w"], r["bias"], r["wp"], nh_r, r["scale"]),
                flops + 2 * b * l * hd * wd,
                nbytes + 2 * r["wp"].numel() + 4 * b * l * wd))
    return finish_rows(rows, errs)


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------


def omni_inputs(seed: int = 0):
    """bench.py's omni sample batch, made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        image=rng.standard_normal((S, 1, 3, 224, 224)).astype(f),
        video=rng.standard_normal((S, 4, 3, 224, 224)).astype(f),
        audio=rng.standard_normal((S, 2, 224, 224)).astype(f),
        ids=rng.integers(200, 20000, (S, TEXT_LEN)).astype(np.int64),
        mask=np.ones((S, TEXT_LEN), np.int64),
    )


def omni_step(model, image, video, audio, ids, mask):
    """bench.py's step: every frame in one ViT pass, heads v/v/a/t, the
    similarity of each text to every image, video and audio embedding."""
    aud3 = audio[:, :, None].expand(-1, -1, 3, -1, -1)
    frames = torch.cat([image, video, aud3], dim=1)
    tokens = model.forward_vision_encoder(frames)

    def head(name, pooled):
        f = model.contra_head(name, pooled).float()
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    feats = {name: head(h, pool(tokens[:, lo:hi]))
             for name, h, pool, lo, hi in (
                 ("image", "v", model.pool_vision_for_contra, 0, 1),
                 ("video", "v", model.pool_vision_for_contra, 1, 5),
                 ("audio", "a", model.pool_audio_for_contra, 5, 7))}
    seq = model.forward_multimodal_encoder(ids, mask)
    feats["text"] = head("t", model.pool_text_for_contra(seq))
    feats["sims"] = feats["text"] @ torch.cat(
        [feats["image"], feats["video"], feats["audio"]]).T
    return feats


def itm_probs(model, image, ids, mask, vision_output=None):
    """ITM of one image against every caption (inference_demo.py:75-86);
    `vision_output` given: the ViT's tokens of that image, not recomputed."""
    if vision_output is None:
        vision_output = model.forward_vision_encoder(image)
    cond = model.get_multimodal_forward_input_vision(vision_output)
    cond = cond.expand(ids.shape[0], -1, -1)
    seq = model.forward_multimodal_encoder(ids, mask, cond)
    return torch.softmax(model.itm_head(seq[:, 0]).float(), dim=1)[:, 1]


CAPTIONS = ["a man is skiing in a snowy day.", "it's a hot day",
            "two dogs play with a red ball on the grass"]


def run_counted(fa, paths: dict, what: str, fn, **want):
    """Run one path with every launch count set to 0 just before it, keep
    its own counts in `paths[what]` and hold them to the path's (`want`
    names the kernels it launches; every other count must stay 0)."""
    fa.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = fa.launch_counts()
    paths[what] = got
    unknown = set(want) - set(got)
    want = {name: want.get(name, 0) for name in got}
    if unknown or got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}"
                             + (f"; unknown kernels {unknown}" if unknown
                                else ""))
    return out


def check_run_20(pipe, feats, cfg) -> None:
    """`_run` over 20 images with item 5 failed: one zero row there, unit
    rows elsewhere."""
    if pipe.last_failures != [5] or feats.shape != (20, cfg.contra_dim):
        raise AssertionError(f"_run: failures {pipe.last_failures}, "
                             f"shape {feats.shape}")
    if np.abs(feats[5]).max() != 0.0:
        raise AssertionError("_run: the failed item's row is not zero")
    check_unit("_run", torch.from_numpy(np.delete(feats, 5, axis=0)))


def check_unit(name, feats):
    if not torch.isfinite(feats).all():
        raise AssertionError(f"{name}: non-finite values")
    norms = torch.linalg.vector_norm(feats.float(), dim=-1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-3):
        raise AssertionError(f"{name}: norms {norms.tolist()} are not 1")


def phase_main(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.text import BertWordPieceTokenizer

    cfg = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    t0 = time.perf_counter()
    model = MiCo(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    nlayers, nbert = cfg.eva_config.layers, cfg.bert_config.num_hidden_layers
    log(f"phase main: MiCo-ViT-g (ViT {nlayers} layers, width "
        f"{cfg.eva_config.width}; BERT {nbert} layers) bf16 on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    inp = omni_inputs()
    dev = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    tok = BertWordPieceTokenizer()
    enc = tok(CAPTIONS, max_length=TEXT_LEN)
    cap_ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    cap_mask = torch.from_numpy(enc["attention_mask"]).long().cuda()

    paths = {}

    out = run_counted(fa, paths, "omni step",
                      lambda: omni_step(model, **dev), K1=nlayers)
    for name in ("image", "video", "audio", "text"):
        check_unit(f"omni {name}", out[name])
    if out["sims"].shape != (S, 3 * S) or not torch.isfinite(out["sims"]).all():
        raise AssertionError(f"similarity {tuple(out['sims'].shape)} not finite")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        omni_step(model, **dev)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(times)
    log(f"  omni step S={S}: median {step_ms:.2f} ms of {len(times)} "
        f"({[round(t, 2) for t in times]}), {1e3 * S / step_ms:.2f} samples/s "
        f"[{card}]")

    itm = run_counted(
        fa, paths, "ITM",
        lambda: itm_probs(model, dev["image"][:1], cap_ids, cap_mask),
        K1=nlayers, K2=nbert)
    if itm.shape != (3,) or not torch.isfinite(itm).all():
        raise AssertionError(f"ITM probabilities {itm}")
    log(f"  ITM 1 image x 3 captions: {[round(p, 5) for p in itm.tolist()]}")

    pipe = EmbeddingPipeline(model, cfg, tok, batch_size=8, io_workers=4)
    try:
        tf = run_counted(fa, paths, "embed_texts",
                         lambda: pipe.embed_texts(CAPTIONS))
        check_unit("embed_texts", torch.from_numpy(tf))
        images = [inp["image"][i % S] for i in range(20)]
        images[5] = None
        feats = run_counted(
            fa, paths, "_run 20 images",
            lambda: pipe._run(images, lambda a: a,
                              lambda m, x: pipe._embed_pixels(m, x, head="v")),
            K1=3 * nlayers)
    finally:
        pipe.close()
    check_run_20(pipe, feats, cfg)
    # the folded model must agree with the canonical one on the same frame
    folded_cos = float(feats[0] @ out["image"][0].cpu().numpy())
    log(f"  pipeline: texts {tf.shape}, images {feats.shape}, failures "
        f"{pipe.last_failures}, folded vs canonical image cosine "
        f"{folded_cos:.6f}")
    if not folded_cos >= COSINE_MIN:
        raise AssertionError(f"folded pipeline cosine {folded_cos}")
    log(f"  launches by path (each counted from 0): {paths}")
    return dict(cfg=cfg, model=model, tok=tok, out=out, itm=itm, inp=inp,
                cap_ids=cap_ids.cpu(), cap_mask=cap_mask.cpu(),
                step_ms=step_ms, step_times=times, paths=paths)


# ---------------------------------------------------------------------------
# phase 4: card bf16 against CPU fp32
# ---------------------------------------------------------------------------


def phase_cosine(main: dict):
    from mico_tpu_torch.models.mico import MiCo

    cfg = dataclasses.replace(main["cfg"], compute_dtype="float32")
    t0 = time.perf_counter()
    ref = MiCo(cfg, device="cpu", seed=0)
    one = {k: torch.from_numpy(v[:1]) for k, v in main["inp"].items()}
    with torch.inference_mode():
        want = omni_step(ref, **one)
        itm_want = itm_probs(ref, one["image"], main["cap_ids"], main["cap_mask"])
    log(f"phase cosine: CPU fp32 reference in {time.perf_counter() - t0:.1f} s")
    result = {}
    for name in ("image", "video", "audio", "text"):
        got = main["out"][name][:1].cpu().double()
        cos = torch.nn.functional.cosine_similarity(
            got, want[name].double()).item()
        result[name] = cos
        log(f"  {name}: cosine {cos:.6f}")
        if not cos >= COSINE_MIN:
            raise AssertionError(f"{name} cosine {cos} < {COSINE_MIN}")
    gap = (main["itm"].cpu() - itm_want).abs().max().item()
    result["itm_max_abs_diff"] = gap
    log(f"  ITM probabilities: card {main['itm'].tolist()} vs CPU "
        f"{itm_want.tolist()}, max |d| {gap:.3e}")
    if not gap <= ITM_PROB_TOL:
        raise AssertionError(f"ITM probability gap {gap} > {ITM_PROB_TOL}")
    return result, ref


# ---------------------------------------------------------------------------
# phase 5: caption and QA generation
# ---------------------------------------------------------------------------

QUESTION = "what is the man doing in the snow?"
QUESTION_LEN = 25           # the VQA prefix of scripts/decode_bench.py


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0).item()


def check_tokens(name: str, tokens: torch.Tensor, n: int, vocab: int):
    from mico_tpu_torch.config import BERT_CLS_ID

    if (tuple(tokens.shape) != (tokens.shape[0], n + 1)
            or not (tokens[:, 0] == BERT_CLS_ID).all()
            or tokens.min() < 0 or tokens.max() >= vocab):
        raise AssertionError(f"{name}: bad tokens {tokens.tolist()}")


def timed_runs(fn, runs: int) -> list:
    """Host-clock ms of `runs` calls after one warm-up, each ending in a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


@torch.no_grad()
def phase_caption(fa, main: dict, ref, card: str) -> dict:
    from mico_tpu_torch import generation as gen
    from mico_tpu_torch.config import BERT_MASK_ID, BERT_PAD_ID

    model, tok, inp = main["model"], main["tok"], main["inp"]
    bert, vocab = model.bert, model.cfg.bert_config.vocab_size
    nbert = model.cfg.bert_config.num_hidden_layers
    paths, captions = {}, {}
    conds = {}
    for name in ("image", "video"):
        px = torch.from_numpy(inp[name][:1]).cuda()
        conds[name] = model.get_multimodal_forward_input_vision(
            model.forward_vision_encoder(px))
    log(f"phase caption: conditions image {tuple(conds['image'].shape)}, "
        f"video {tuple(conds['video'].shape)} {conds['image'].dtype}")

    # 1. end to end, each path counted from 0
    for name, cond in conds.items():
        for route, i8 in (("bf16", False), ("int8", True)):
            what = f"{route} beam caption ({name})"
            out = run_counted(
                fa, paths, what,
                lambda: gen.generate(bert, cond, mode="beam", num_beams=3,
                                     length_penalty=0.6,
                                     max_new_tokens=NEW_TOKENS,
                                     int8_cross_kv=i8),
                K7=nbert * NEW_TOKENS if i8 else 0)
            check_tokens(what, out, NEW_TOKENS, vocab)
            captions[what] = tok.batch_decode(out[:, 1:].tolist())[0]
    enc = tok([QUESTION], max_length=QUESTION_LEN)
    qids = torch.from_numpy(enc["input_ids"]).long().cuda()
    qmask = torch.from_numpy(enc["attention_mask"]).long().cuda()
    what = "int8 QA beam (image)"
    ans = run_counted(
        fa, paths, what,
        lambda: gen.generate_answers(bert, qids, qmask, conds["image"],
                                     mode="beam", num_beams=3,
                                     max_new_tokens=10, int8_cross_kv=True),
        K7=nbert * 10)
    check_tokens(what, ans, 10, vocab)
    captions[what] = tok.batch_decode(ans[:, 1:].tolist())[0]
    what = "recompute greedy caption (video)"
    rec = run_counted(
        fa, paths, what,
        lambda: gen.generate(bert, conds["video"], mode="greedy",
                             use_cache=False, max_new_tokens=8),
        K2=nbert * 8)
    check_tokens(what, rec, 8, vocab)
    captions[what] = tok.batch_decode(rec[:, 1:].tolist())[0]
    for what, text in captions.items():
        log(f"  {what}: {text!r}")
    log(f"  launches by path (each counted from 0): {paths}")

    # 2. the card's bf16 greedy caption of the image against the CPU fp32
    # port, step by step on the card's tokens; the int8 route's logits on
    # the same tokens against the bf16 route's
    cond = conds["image"]
    toks, logits = gen.cached_generate(
        bert, cond, max_new_tokens=NEW_TOKENS, compute_dtype=torch.bfloat16,
        return_logits=True)
    _, logits8 = gen.cached_generate(
        bert, cond, max_new_tokens=NEW_TOKENS, compute_dtype=torch.bfloat16,
        int8_cross_kv=True, teacher_tokens=toks[:, 1:], return_logits=True)
    toks8 = gen.cached_generate(bert, cond, max_new_tokens=NEW_TOKENS,
                                compute_dtype=torch.bfloat16,
                                int8_cross_kv=True)
    t0 = time.perf_counter()
    ref_cond = ref.get_multimodal_forward_input_vision(
        ref.forward_vision_encoder(torch.from_numpy(inp["image"][:1])))
    toks_cpu, logits_cpu = toks.cpu(), logits.cpu()
    buf = torch.full((1, NEW_TOKENS + 2), BERT_PAD_ID, dtype=torch.long)
    cos_cpu, cos_i8, checked = [], [], 0
    for step in range(NEW_TOKENS):
        buf[:, :step + 1] = toks_cpu[:, :step + 1]
        buf[:, step + 1] = BERT_MASK_ID
        want = gen._decode_logits(ref.bert, buf, step + 1, ref_cond, None,
                                  torch.float32)[0]
        cos_cpu.append(cosine(logits_cpu[0, step], want))
        cos_i8.append(cosine(logits8[0, step], logits[0, step]))
        top2 = want.topk(2).values
        if (top2[0] - top2[1]).item() >= MARGIN_MIN:
            checked += 1
            if toks_cpu[0, step + 1].item() != want.argmax().item():
                raise AssertionError(
                    f"step {step}: card token {toks_cpu[0, step + 1].item()} "
                    f"!= fp32 argmax {want.argmax().item()} at margin "
                    f"{(top2[0] - top2[1]).item():.4f}")
    agree = (toks8 == toks).float().mean().item()
    log(f"  greedy caption of the image, card bf16 vs CPU fp32 over "
        f"{NEW_TOKENS} steps ({time.perf_counter() - t0:.1f} s on the CPU): "
        f"min logits cosine {min(cos_cpu):.6f}; tokens equal at all "
        f"{checked} steps with fp32 margin >= {MARGIN_MIN}")
    log(f"  int8 vs bf16 route on the same tokens: min logits cosine "
        f"{min(cos_i8):.6f}; free-running greedy token agreement {agree:.4f}")
    if not min(cos_cpu) >= COSINE_MIN:
        raise AssertionError(f"card vs CPU logits cosine {min(cos_cpu)}")
    if not min(cos_i8) >= COSINE_MIN:
        raise AssertionError(f"int8 vs bf16 logits cosine {min(cos_i8)}")

    # 3. times at the captioner deployment shape
    g = torch.Generator(device="cuda").manual_seed(1)
    width = bert.cfg.encoder_width
    cond = torch.randn((DEPLOY_B, DEPLOY_COND, width), generator=g,
                       device="cuda", dtype=torch.bfloat16)
    times = {}
    for mode in ("beam", "sample"):
        for route, i8, split in (("bf16", False, False),
                                 ("bf16 split heads", False, True),
                                 ("int8", True, False)):
            gen.CROSS_KV_SPLIT_HEADS = split
            try:
                runs = timed_runs(lambda: gen.generate(
                    bert, cond, mode=mode, num_beams=3, top_k=10,
                    max_new_tokens=NEW_TOKENS, int8_cross_kv=i8), runs=5)
            finally:
                gen.CROSS_KV_SPLIT_HEADS = False
            ms = statistics.median(runs)
            times[f"{mode} {route}"] = dict(
                ms_per_batch=ms, runs_ms=runs,
                captions_per_s=1e3 * DEPLOY_B / ms,
                ms_per_step=ms / NEW_TOKENS)
            log(f"  decode {mode} {route}: B={DEPLOY_B}, condition "
                f"({DEPLOY_B}, {DEPLOY_COND}, {width}), {NEW_TOKENS} new "
                f"tokens: "
                f"{ms:.2f} ms/batch (median of {runs}), "
                f"{1e3 * DEPLOY_B / ms:.2f} captions/s, "
                f"{ms / NEW_TOKENS:.3f} ms/step [{card}]")
    return dict(paths=paths, captions=captions,
                logits_cosine_cpu_min=min(cos_cpu),
                logits_cosine_int8_min=min(cos_i8),
                margin_checked_steps=checked, int8_token_agreement=agree,
                deploy=times)


# ---------------------------------------------------------------------------
# phase 1b: the host's audio decoder (FLAC, WAV, resampling)
# ---------------------------------------------------------------------------

AUDIO_SECONDS = 10
AUDIO_RATES = (22050, 44100, 48000, 16001)    # each resampled to 16 kHz
RESAMPLE_PLAIN_TOL = 1e-6


def flac_writer():
    """`tests/torch_flac_writer.write_flac`, loaded by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "torch_flac_writer.py"
    spec = importlib.util.spec_from_file_location("torch_flac_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.write_flac


def phase_audio_decode(card: str) -> dict:
    import os
    import tempfile

    from mico_tpu_torch.media import audio_io
    from mico_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build_host("audio_decode")
    build_s = time.perf_counter() - t0
    log(f"phase audio_decode: {lib.name} built by g++ in {build_s:.1f} s")
    rng = np.random.default_rng(0)
    write = flac_writer()
    result = {"build_s": build_s, "flac": {}, "resample": {}}
    t = np.arange(AUDIO_SECONDS * 44100) / 44100
    x = np.stack([0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t),
                  0.3 * np.sin(2 * np.pi * 440 * t)], 1)
    x = x + 0.05 * rng.standard_normal(x.shape)
    with tempfile.TemporaryDirectory() as tmp:
        for bps in (16, 24):
            pcm = np.round(x * ((1 << (bps - 1)) - 1)).astype(np.int64)
            path = f"{tmp}/a{bps}.flac"
            write(path, pcm, 44100, bps, subframes=[("lpc", 12), ("fixed", 2)],
                  assignments=["independent", "left_side", "side_right",
                               "mid_side"])
            got, sr = audio_io.load_waveform(path, target_sr=0)
            dec_s = min(timed_runs(
                lambda: audio_io.load_waveform(path, target_sr=0), 3)) / 1e3
            want = (pcm[:, 0] / 2.0 ** (bps - 1)).astype(np.float32)
            if sr != 44100 or not np.array_equal(got, want):
                raise AssertionError(f"audio_decode: the {bps}-bit FLAC "
                                     f"decoded unequal to its PCM (sr {sr})")
            res, _ = audio_io.load_waveform(path, target_sr=16000)
            both_s = min(timed_runs(
                lambda: audio_io.load_waveform(path, target_sr=16000),
                3)) / 1e3
            if res.shape != (AUDIO_SECONDS * 16000,):
                raise AssertionError(f"audio_decode: {res.shape} at 16 kHz")
            result["flac"][bps] = dict(
                bytes=os.path.getsize(path),
                decode_s=dec_s, decode_resample_s=both_s,
                decode_audio_s_per_s=AUDIO_SECONDS / dec_s,
                decode_resample_audio_s_per_s=AUDIO_SECONDS / both_s)
            log(f"  {bps}-bit stereo FLAC of {AUDIO_SECONDS} s "
                f"({result['flac'][bps]['bytes']} bytes): equal to its PCM "
                f"bit for bit; decode {AUDIO_SECONDS / dec_s:.1f} s of audio "
                f"a second, decode + resample to 16 kHz "
                f"{AUDIO_SECONDS / both_s:.1f} (best of 3 after a warm-up, "
                f"one host thread of the card's machine)")
    for rate in AUDIO_RATES:
        n = AUDIO_SECONDS * rate
        tt = np.arange(n) / rate
        sig = (0.5 * np.sin(2 * np.pi * (100 + 0.2 * rate * tt / AUDIO_SECONDS)
                            * tt) + 0.3 * rng.uniform(-1, 1, n)).astype(
                                np.float32)
        got = audio_io.resample(sig, rate, 16000)
        res_s = min(timed_runs(
            lambda: audio_io.resample(sig, rate, 16000), 3)) / 1e3
        plain = audio_io.resample_plain(sig, rate, 16000)
        if got.shape != plain.shape:
            raise AssertionError(f"resample {rate}: {got.shape} vs the plain "
                                 f"version's {plain.shape}")
        err = float(np.abs(got - plain).max())
        if not err <= RESAMPLE_PLAIN_TOL:
            raise AssertionError(f"resample {rate} -> 16000: max |d| {err} "
                                 f"> {RESAMPLE_PLAIN_TOL}")
        result["resample"][rate] = dict(
            out_samples=int(got.size), max_abs_err=err, seconds=res_s,
            audio_s_per_s=AUDIO_SECONDS / res_s)
        log(f"  resample {rate} -> 16000 Hz: {got.size} samples, max |d| "
            f"{err:.3e} to the plain version; {AUDIO_SECONDS / res_s:.1f} s "
            f"of audio a second")
    log(f"  (host rates: the CPU of the card's machine [{card}])")
    return result


# ---------------------------------------------------------------------------
# phase 5b: the demo entry from a released-layout checkpoint directory
# ---------------------------------------------------------------------------

MANIFEST = "tests/fixtures/mico_vit_g_manifest.json"
# the released checkpoint's entries that hold no weight
NON_WEIGHTS = {"multimodal_encoder.bert.embeddings.position_ids",
               "multimodal_encoder.cls.predictions.decoder.bias",
               "vision_encoder.logit_scale"}
DEMO_STEP = 1200              # the newest checkpoint; an older one sits beside
# the released MiCo-g run's config as `tests/test_checkpoints.py` builds it
DEMO_MODEL_CFG = {"vision_encoder_type": "evaclip01_giant", "contra_dim": 512,
                  "max_vision_sample_num": 4, "max_audio_sample_num": 2,
                  "max_depth_sample_num": 2}
DEMO_STAGES = {"image ViT": {"K1": 40}, "text": {}, "ITM": {"K2": 12},
               "caption": {}, "video ViT": {"K1": 40},
               "audio ViT": {"K1": 40}}


class RssPeak:
    """The process's peak resident set, sampled every 5 ms by a thread
    (/proc/self/statm: file-backed pages of a mapped checkpoint count)."""

    def __init__(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.start = self.peak = self.now()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def now(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self.now())

    def close(self) -> int:
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.now())
        return self.peak


def released_state_dict(manifest: dict, seed: int) -> dict:
    """Every manifest entry at its shape in fp16 on the CPU: LayerNorm
    weights 1, biases 0, the rest N(0, 0.02) drawn on the card from `seed`;
    the position-id buffer and the temperatures as a checkpoint holds
    them."""
    import math

    gen = torch.Generator("cuda").manual_seed(seed)
    sd = {}
    for k, shape in manifest.items():
        if k.endswith("position_ids"):
            sd[k] = torch.arange(shape[-1]).reshape(shape)
        elif k == "contra_temp":
            sd[k] = torch.tensor(0.07, dtype=torch.float16)
        elif k.endswith("logit_scale"):
            sd[k] = torch.tensor(math.log(1 / 0.07), dtype=torch.float16)
        elif k.endswith("bias"):
            sd[k] = torch.zeros(shape, dtype=torch.float16)
        elif k.endswith(".weight") and (
                "norm" in k.lower() or (k.startswith("hidden_trans_")
                                        and k.endswith(".1.weight"))):
            sd[k] = torch.ones(shape, dtype=torch.float16)
        else:
            sd[k] = torch.empty(shape, device="cuda").normal_(
                0.0, 0.02, generator=gen).half().cpu()
    return sd


def write_demo_inputs(root, seed: int, manifest: dict,
                      model_cfg: dict) -> dict:
    """A released-layout directory (`log/hps.json` holding `model_cfg`,
    `ckpt/model_step_N.pt` with every `manifest` entry, an older
    `model_step_M.pt` and an unfinished `-tmp` save beside it) and the
    demo's media: a 320x240 PPM image, a directory of 8 PPM frames and a
    10 s 44.1 kHz stereo 16-bit FLAC (a chirp and a tone plus noise; the
    demo decodes it and resamples it to 16 kHz), all drawn from `seed`."""
    import os
    from pathlib import Path

    root = Path(root)
    pre = root / "MiCo-g"
    (pre / "log").mkdir(parents=True)
    (pre / "log" / "hps.json").write_text(json.dumps(
        {"model_cfg": model_cfg}))
    ckpt = pre / "ckpt"
    ckpt.mkdir()
    t0 = time.perf_counter()
    sd = released_state_dict(manifest, seed)
    torch.save(sd, ckpt / f"model_step_{DEMO_STEP}.pt")
    del sd
    torch.save({"contra_temp": torch.tensor(1.0)},
               ckpt / f"model_step_{DEMO_STEP // 2}.pt")
    (ckpt / f"model_step_{2 * DEMO_STEP}-tmp").mkdir()
    write_s = time.perf_counter() - t0

    rng = np.random.default_rng(seed)

    def ppm(path, h=240, w=320):
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // w, y * 255 // h, (x + y) % 256], -1)
        img = (img + rng.integers(-20, 21, img.shape)).clip(0, 255)
        with open(path, "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode())
            f.write(img.astype(np.uint8).tobytes())

    ppm(root / "image.ppm")
    frames = root / "frames"
    frames.mkdir()
    for i in range(8):
        ppm(frames / f"{i:04d}.ppm")
    t = np.arange(10 * 44100) / 44100
    x = np.stack([0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t),
                  0.3 * np.sin(2 * np.pi * 440 * t)], 1)
    x = x + 0.05 * rng.standard_normal(x.shape)
    flac_writer()(root / "audio.flac", np.round(x * 32767).astype(np.int64),
                  44100, 16, assignments=["mid_side", "left_side"])
    return dict(pretrain_dir=str(pre), image=str(root / "image.ppm"),
                video=str(frames), audio=str(root / "audio.flac"),
                write_s=write_s,
                ckpt_bytes=os.path.getsize(ckpt / f"model_step_{DEMO_STEP}.pt"))


def phase_demo(fa, card: str) -> dict:
    import tempfile
    from pathlib import Path

    from mico_tpu_torch.inference_demo import run_demo

    manifest = json.loads((Path(__file__).resolve().parent
                           / MANIFEST).read_text())
    with tempfile.TemporaryDirectory() as tmp:
        files = write_demo_inputs(tmp, 0, manifest, DEMO_MODEL_CFG)
        log(f"phase demo: wrote {len(manifest)} fp16 entries "
            f"({files['ckpt_bytes'] / 2**30:.2f} GiB) in "
            f"{files['write_s']:.1f} s, a 320x240 PPM, 8 PPM frames and a "
            f"10 s 44.1 kHz stereo FLAC")
        args = (files["pretrain_dir"], files["image"], files["video"],
                files["audio"])
        paths = {}
        consumed = set()
        rss = RssPeak()
        load_rss = []

        def stage(name, fn):
            if not load_rss:              # the load has just finished
                load_rss.append(rss.peak)
            return run_counted(fa, paths, f"demo {name}", fn,
                               **DEMO_STAGES[name])

        t0 = time.perf_counter()
        try:
            card_out = run_demo(*args, dtype="bfloat16", device="cuda",
                                consumed=consumed, stage=stage)
        finally:
            peak = rss.close()
        wall = time.perf_counter() - t0
        leftover = set(manifest) - consumed
        if leftover != NON_WEIGHTS:
            raise AssertionError(f"demo: unread checkpoint keys {leftover}, "
                                 f"expected {NON_WEIGHTS}")
        times = card_out["times"]
        log(f"  card run [{card}]: wall {wall:.2f} s = load "
            f"{times['load']:.2f} s + decode/preprocess "
            f"{times['preprocess']:.2f} s + device {times['device']:.2f} s "
            f"(rest {wall - sum(times.values()):.2f} s); host RSS "
            f"{rss.start / 2**30:.2f} GiB before, peak "
            f"{load_rss[0] / 2**30:.2f} GiB by the end of the load, "
            f"{peak / 2**30:.2f} GiB over the run")
        log(f"  launches by stage (each counted from 0): {paths}")
        t0 = time.perf_counter()
        ref = run_demo(*args, dtype="float32", device="cpu")
        log(f"  CPU fp32 run in {time.perf_counter() - t0:.1f} s "
            f"(load {ref['times']['load']:.2f} s)")
    result = {"wall_s": wall, "times_s": times, "rss_before_bytes": rss.start,
              "rss_peak_load_bytes": load_rss[0], "rss_peak_bytes": peak,
              "params": card_out["n_params"], "paths": paths}
    for name in ("image", "video", "audio", "text"):
        got, want = (torch.from_numpy(o[f"feat_{name}"]) for o in (card_out,
                                                                   ref))
        cos = min(torch.nn.functional.cosine_similarity(
            got.double(), want.double()).tolist())
        result[f"cosine_{name}"] = cos
        log(f"  {name} embedding: cosine {cos:.6f} to the CPU fp32 run")
        if not cos >= COSINE_MIN:
            raise AssertionError(f"demo {name} cosine {cos} < {COSINE_MIN}")
    gap = float(np.abs(card_out["itm"] - ref["itm"]).max())
    result["itm_max_abs_diff"] = gap
    log(f"  ITM: card {card_out['itm'].tolist()} vs CPU "
        f"{ref['itm'].tolist()}, max |d| {gap:.3e}")
    if not gap <= ITM_PROB_TOL:
        raise AssertionError(f"demo ITM gap {gap} > {ITM_PROB_TOL}")
    vocab = card_out["cfg"].bert_config.vocab_size
    check_tokens("demo caption", torch.from_numpy(card_out["caption_tokens"]),
                 NEW_TOKENS, vocab)
    result["captions"] = {"card": card_out["captions"],
                          "cpu": ref["captions"]}
    log(f"  caption: card {card_out['captions']}, CPU {ref['captions']}")
    for key in ("sim_t2v", "video_sim", "audio_sim"):
        result[key] = card_out[key].tolist()
    return result


# ---------------------------------------------------------------------------
# phase 5c: .orbax checkpoints without JAX
# ---------------------------------------------------------------------------

ORBAX_FIXTURES = "tests/fixtures/orbax"
ORBAX_PHASE_S = 60          # the phase's budget inside the script's 1200 s
ORBAX_RUN_ITEMS = 8         # one batch of RUN_B: the resume run's corpus


def orbax_recipe():
    """`tests/torch_orbax_recipe.py` (numpy alone), loaded by path."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parent / "tests"
            / "torch_orbax_recipe.py")
    spec = importlib.util.spec_from_file_location("torch_orbax_recipe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def hold_fixtures(checkpoints) -> int:
    """Every leaf of the committed fixtures, model and optimizer, bit for
    bit against the recipe; → the leaves held."""
    import os

    rc = orbax_recipe()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ORBAX_FIXTURES)
    held = 0
    for kind in ("single", "multi"):
        files = [(f"model_step_{rc.MODEL_STEP}", rc.model_leaves(kind))]
        if kind == "single":
            files.append((f"optimizer_step_{rc.MODEL_STEP}",
                          rc.optimizer_leaves(kind)))
        for name, leaves in files:
            tree = checkpoints.load_checkpoint_path(
                os.path.join(root, kind, "ckpt", f"{name}.orbax"))
            for keys, dtype, want in leaves:
                node = tree
                for k in keys:
                    node = node[k]
                got = host_bits(node)
                if got.dtype != want.dtype or not np.array_equal(got, want):
                    raise AssertionError(f"orbax fixture {kind}/{name} "
                                         f"{keys}: not the recipe's bits")
                held += 1
    return held


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_orbax(fa, card: str) -> dict:
    import os
    import shutil
    import tempfile

    import mico_tpu_torch.run as run_mod
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.run import main as run_main
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.text import BertWordPieceTokenizer
    from mico_tpu_torch.train import checkpoints

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _build.build_host("zstd_decode")
    build_s = time.perf_counter() - t0
    log(f"phase orbax: zstd decoder built by g++ in {build_s:.1f} s")
    t0 = time.perf_counter()
    held = hold_fixtures(checkpoints)
    log(f"  fixtures: {held} leaves of JAX's one-process and two-process "
        f"saves bit for bit in {time.perf_counter() - t0:.2f} s")

    # -- ViT-g at full width: save, load, embed --
    cfg = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    nlayers = cfg.eva_config.layers
    paths = {}
    root = tempfile.mkdtemp(prefix="mico_orbax_")
    try:
        t0 = time.perf_counter()
        model32 = MiCo(cfg, device="cuda", seed=0, init_device="cuda")
        live = copy.deepcopy(model32).to(dtype=torch.bfloat16)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model32.parameters())
        pretrain = os.path.join(root, "vit_g")
        os.makedirs(os.path.join(pretrain, "log"))
        with open(os.path.join(pretrain, "log", "hps.json"), "w") as f:
            json.dump({"model_cfg": {"max_vision_sample_num": 4,
                                     "max_audio_sample_num": 2}}, f)
        rss = RssPeak()
        t0 = time.perf_counter()
        checkpoints.ModelSaver(pretrain, backend="orbax").save(1, model32)
        write_s = time.perf_counter() - t0
        nbytes = dir_bytes(os.path.join(pretrain, "ckpt"))
        rss_write = rss.peak
        del model32
        free_cuda()
        t0 = time.perf_counter()
        params, lcfg = checkpoints.load_from_pretrained_dir(pretrain)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = mico_from_jax(params, lcfg, device="cuda",
                               dtype=torch.bfloat16)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        del params
        gc.collect()
        rss_peak = rss.close()
        log(f"  MiCo-ViT-g ({n_params / 1e9:.3f} B parameters, fp32) drawn "
            f"on the card in {draw_s:.1f} s; .orbax written in {write_s:.2f} "
            f"s ({nbytes / 1e9:.3f} GB, {nbytes / 1e9 / write_s:.3f} GB/s), "
            f"read by load_from_pretrained_dir in {read_s:.2f} s "
            f"({nbytes / 1e9 / read_s:.3f} GB/s), placed in bf16 in "
            f"{place_s:.2f} s; host RSS {rss.start / 2**30:.2f} GiB before, "
            f"peak {rss_write / 2**30:.2f} GiB over the write and "
            f"{rss_peak / 2**30:.2f} GiB over the write and the load "
            f"[{card}]")
        for k, v in live.state_dict().items():
            if not torch.equal(loaded.state_dict()[k], v):
                raise AssertionError(f"orbax round trip: {k} differs")
        inp = omni_inputs()
        tok = BertWordPieceTokenizer()
        feats = {}
        for name, m in (("live", live), ("loaded", loaded)):
            pipe = EmbeddingPipeline(m, cfg, tok, batch_size=8, io_workers=1)
            try:
                img = run_counted(
                    fa, paths, f"orbax {name} ViT-g image embed",
                    lambda: pipe._run(
                        [inp["image"][0]], lambda a: a,
                        lambda mm, x: pipe._embed_pixels(mm, x, head="v")),
                    K1=nlayers)
                txt = run_counted(fa, paths, f"orbax {name} text embed",
                                  lambda: pipe.embed_texts(CAPTIONS))
            finally:
                pipe.close()
            feats[name] = (img, txt)
        for i, what in enumerate(("image", "text")):
            a, b = feats["live"][i], feats["loaded"][i]
            check_unit(f"orbax {what}", torch.from_numpy(b))
            if not np.array_equal(a, b):
                raise AssertionError(f"orbax {what} embedding: the loaded "
                                     f"model's differs from the live one's")
        log(f"  the loaded model's image and text embeddings equal the live "
            f"model's bit for bit; launches {paths}")
        del live, loaded, feats
        free_cuda()

        # -- the run entry: 2 steps saved as .orbax, resumed to 4 --
        resume = orbax_resume_run(fa, run_mod, run_main, root, paths)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase orbax: {phase_s:.1f} s (budget {ORBAX_PHASE_S} s)")
    if phase_s > ORBAX_PHASE_S:
        raise AssertionError(f"phase orbax took {phase_s:.1f} s, over its "
                             f"budget of {ORBAX_PHASE_S} s")
    return dict(build_s=build_s, fixture_leaves=held, params=n_params,
                checkpoint_bytes=nbytes, write_s=write_s, read_s=read_s,
                place_s=place_s, write_gb_s=nbytes / 1e9 / write_s,
                read_gb_s=nbytes / 1e9 / read_s, rss_before_bytes=rss.start,
                rss_peak_write_bytes=rss_write, rss_peak_bytes=rss_peak,
                resume=resume, phase_s=phase_s, paths=paths)


def orbax_resume_run(fa, run_mod, run_main, root: str, paths: dict) -> dict:
    """`mico_tpu_torch.run` at ViT-g width with RUN_RESUME_LAYERS blocks and
    `checkpoint_backend=orbax`: 2 steps, then a resume to step 4 whose
    loaded weights and moments are the saved ones, bit for bit."""
    import os

    from mico_tpu_torch.config import MiCoConfig

    corpus = write_run_corpus(os.path.join(root, "corpus"), seed=0,
                              items=ORBAX_RUN_ITEMS)
    out = os.path.join(root, "run")
    cut = dict(MiCoConfig().eva_config.__dict__, layers=RUN_RESUME_LAYERS)
    argv = run_argv(corpus, out)
    argv[argv.index("--data_cfg.val") + 1] = "[]"   # saves, no evaluation
    argv += [f"model_cfg.eva_override={json.dumps(cut)}",
             "run_cfg.checkpoint_backend=orbax", "run_cfg.valid_freq=1"]
    seen = {}
    train = run_mod.train

    def spy(cfg, model, optimizer, *a, **kw):
        seen.update(model=model, optimizer=optimizer)
        return train(cfg, model, optimizer, *a, **kw)

    def moments(opt):
        st = opt.torch_optimizer.state
        return [(st[o]["exp_avg"].detach().clone(),
                 st[o]["exp_avg_sq"].detach().clone()) for o in opt.owned]

    loaded = {}
    load_opt, load_model = run_mod.load_latest_opt_state, run_mod.resume_latest

    def load_and_keep(output_dir, optimizer, step=None):
        ok = load_opt(output_dir, optimizer, step=step)
        loaded.update(ok=ok, moments=moments(optimizer),
                      count=optimizer.count)
        return ok

    def resume_and_compare(output_dir, m):
        step = load_model(output_dir, m)
        loaded["weights_equal"] = all(torch.equal(v, saved[k]) for k, v in
                                      m.state_dict().items())
        return step
    run_mod.train = spy
    run_mod.load_latest_opt_state = load_and_keep
    run_mod.resume_latest = resume_and_compare
    try:
        t0 = time.perf_counter()
        rec = run_main(argv + ["run_cfg.num_train_steps=2"])
        first_s = time.perf_counter() - t0
        saved = {k: v.detach().clone()
                 for k, v in seen["model"].state_dict().items()}
        saved_moments = moments(seen["optimizer"])
        files = sorted(os.listdir(os.path.join(out, "ckpt")))
        seen.clear()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        rec2 = run_main(argv + ["run_cfg.num_train_steps=4",
                                "run_cfg.resume=true"])
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        counts = fa.launch_counts()
    finally:
        run_mod.train = train
        run_mod.load_latest_opt_state = load_opt
        run_mod.resume_latest = load_model
    paths["orbax resume run (2 steps)"] = counts
    per_step = 2 * RUN_RESUME_LAYERS        # ret%tva_cap%tva: 2 a block
    want = {k: (2 * per_step if k in ("K3", "K4") else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"orbax resume run: launches {counts}, "
                             f"expected {want}")
    if files != ["model_step_2.orbax", "optimizer_step_2.orbax"]:
        raise AssertionError(f"orbax run: ckpt/ {files}")
    files2 = sorted(os.listdir(os.path.join(out, "ckpt")))
    if files2 != ["model_step_4.orbax", "optimizer_step_4.orbax"]:
        raise AssertionError(f"orbax resume: ckpt/ {files2}")
    if rec2["start_step"] != 2 or rec2["end_step"] != 4:
        raise AssertionError(f"orbax resume: steps {rec2['start_step']} -> "
                             f"{rec2['end_step']}")
    if (not loaded.get("ok") or loaded["count"] != 2
            or not loaded.get("weights_equal")):
        raise AssertionError(f"orbax resume: optimizer loaded "
                             f"{loaded.get('ok')}, count {loaded.get('count')}"
                             f", weights equal {loaded.get('weights_equal')}")
    for (m, v), (m0, v0) in zip(loaded["moments"], saved_moments):
        if not (torch.equal(m, m0) and torch.equal(v, v0)):
            raise AssertionError("orbax resume: moments differ from saved")
    steps = rec["steps"] + rec2["steps"]
    for s in steps:
        bad = [k for k, v in s["losses"].items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"orbax run step {s['step']}: non-finite "
                                 f"{bad}")
    log(f"  run entry at ViT-g width, {RUN_RESUME_LAYERS} blocks, "
        f"checkpoint_backend=orbax: 2 steps in {first_s:.1f} s, resume to "
        f"step 4 in {second_s:.1f} s; loaded weights and moments (update "
        f"count 2) equal the saved ones bit for bit; losses "
        f"{[{k: round(v, 5) for k, v in s['losses'].items()} for s in steps]}"
        f"; launches over the resumed steps {counts}")
    del saved
    return dict(first_s=first_s, second_s=second_s,
                losses=[s["losses"] for s in steps], launches=counts)


# ---------------------------------------------------------------------------
# phase 6: MiCo on the post-norm EVA02-CLIP-bigE tower (K5, K8)
# ---------------------------------------------------------------------------


def min_row_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=-1).min().item()


def phase_bige(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.text import BertWordPieceTokenizer

    # the fp32 reference below runs on the card: both TF32 switches off, so
    # its products and convolutions stay fp32 (mico_tpu_torch.ops.layers
    # sets the same at import)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MiCoConfig(vision_encoder_type="evaclip02_bige",
                     max_vision_sample_num=4, max_audio_sample_num=2)
    eva = cfg.eva_config
    nlayers, nbert = eva.layers, cfg.bert_config.num_hidden_layers
    t0 = time.perf_counter()
    # one draw of the fp32 weights, by the card's generator; the bf16 model
    # is a copy of them
    model32 = MiCo(cfg, device="cuda", seed=0, init_device="cuda")
    model = copy.deepcopy(model32).to(dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0
    n_vit = sum(p.numel() for p in model.vision_encoder.parameters())
    log(f"phase bigE: MiCo on EVA02-CLIP-bigE-14-plus (post-norm ViT "
        f"{nlayers} layers, width {eva.width}, {eva.num_heads} heads of "
        f"{eva.head_dim}, MLP {eva.mlp_hidden}; {n_vit / 1e9:.3f} B tower "
        f"parameters; BERT {nbert} layers), fp32 drawn and a bf16 copy made "
        f"on the card in {build_s:.1f} s; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}")
    inp = omni_inputs()
    dev = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    tok = BertWordPieceTokenizer()
    enc = tok(CAPTIONS, max_length=TEXT_LEN)
    cap_ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    cap_mask = torch.from_numpy(enc["attention_mask"]).long().cuda()
    paths = {}

    out = run_counted(fa, paths, "bigE omni step",
                      lambda: omni_step(model, **dev), K5=nlayers)
    for name in ("image", "video", "audio", "text"):
        check_unit(f"bigE omni {name}", out[name])
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        omni_step(model, **dev)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    log(f"  bigE omni step S={S}: median {step_ms:.2f} ms of {len(times)} "
        f"({[round(x, 2) for x in times]}), {1e3 * S / step_ms:.3f} "
        f"samples/s, peak memory {peak / 2 ** 30:.2f} GiB, of it "
        f"{resident / 2 ** 30:.2f} GiB resident before the step (the fp32 "
        f"and bf16 models and the inputs) [{card}]")

    itm = run_counted(
        fa, paths, "bigE ITM",
        lambda: itm_probs(model, dev["image"][:1], cap_ids, cap_mask),
        K5=nlayers, K2=nbert)
    if itm.shape != (3,) or not torch.isfinite(itm).all():
        raise AssertionError(f"bigE ITM probabilities {itm}")
    log(f"  bigE ITM 1 image x 3 captions: {[round(p, 5) for p in itm.tolist()]}")

    pipe = EmbeddingPipeline(model, cfg, tok, batch_size=8, io_workers=4)
    try:
        if pipe.model.vision_encoder.blocks[0].get("norm1_w") is None:
            raise AssertionError("the folded post-norm copy lost its LNs")
        images = [inp["image"][i % S] for i in range(20)]
        images[5] = None
        feats = run_counted(
            fa, paths, "bigE _run 20 images",
            lambda: pipe._run(images, lambda a: a,
                              lambda m, x: pipe._embed_pixels(m, x, head="v")),
            K5=3 * nlayers)
    finally:
        pipe.close()
    check_run_20(pipe, feats, cfg)
    del pipe
    folded_cos = float(feats[0] @ out["image"][0].cpu().numpy())
    log(f"  bigE pipeline: images {feats.shape}, failure row zero, folded "
        f"vs canonical image cosine {folded_cos:.6f}")
    if not folded_cos >= COSINE_MIN:
        raise AssertionError(f"bigE folded pipeline cosine {folded_cos}")

    fa.FUSED_ATTN_PROJ = True
    try:
        out8 = run_counted(fa, paths, "bigE omni step (FUSED_ATTN_PROJ)",
                           lambda: omni_step(model, **dev), K8=nlayers)
        times8 = timed_runs(lambda: omni_step(model, **dev), runs=3)
    finally:
        fa.FUSED_ATTN_PROJ = False
    k8_cos = {name: min_row_cosine(out8[name], out[name])
              for name in ("image", "video", "audio", "text")}
    log(f"  bigE omni step with FUSED_ATTN_PROJ (K8): median "
        f"{statistics.median(times8):.2f} ms of {len(times8)}; min cosine "
        f"to the K5 route's embeddings {k8_cos}")
    for name, c in k8_cos.items():
        if not c >= COSINE_MIN:
            raise AssertionError(f"K8 vs K5 route {name} cosine {c}")

    # the reference: the same one-sample inputs through the fp32 weights on
    # the plain routes (plain attention, fp32 compute), on the card
    model32.cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                      use_flash_attention=False)
    one = {k: v[:1] for k, v in dev.items()}
    t0 = time.perf_counter()
    want = run_counted(fa, paths, "bigE fp32 plain reference",
                       lambda: omni_step(model32, **one))
    tok32 = model32.forward_vision_encoder(one["image"])
    itm_want = itm_probs(model32, None, cap_ids, cap_mask, tok32)
    log(f"  bigE fp32 plain reference on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    cosines = {}
    for name in ("image", "video", "audio", "text"):
        cosines[name] = min_row_cosine(out[name][:1], want[name])
        log(f"  bigE {name}: card bf16 vs card fp32 cosine "
            f"{cosines[name]:.6f}")
    # The image's ViT tokens on the kernel route and on the bf16 plain
    # routes (the JAX package's bf16 rounding without the kernels), each
    # against fp32: the kernels may add no error of their own.
    tok_err = {"kernels": model.forward_vision_encoder(one["image"])}
    model.cfg = dataclasses.replace(cfg, use_flash_attention=False)
    tok_err["plain"] = model.forward_vision_encoder(one["image"])
    model.cfg = cfg
    tok_err = {k: ((t.float() - tok32).norm() / tok32.norm()).item()
               for k, t in tok_err.items()}
    # The ITM path in bf16 (BERT, K2, the heads) over the fp32 tower's
    # tokens, and the whole bf16 route's ITM. At seed 0 the post-norm
    # tower's attention is near-argmax, so every bf16 route of the tower
    # leaves ~3% relative error in its tokens and the whole route's ITM
    # gap scatters with an rms of 5-7e-3 over images
    # (scripts/torch_bige_precision.py); it is reported, not held.
    itm_path = itm_probs(model, None, cap_ids, cap_mask,
                         tok32.to(torch.bfloat16))
    path_gap = (itm_path - itm_want).abs().max().item()
    gap = (itm - itm_want).abs().max().item()
    log(f"  bigE ViT tokens' relative error to fp32: kernel route "
        f"{tok_err['kernels']:.5f}, bf16 plain route {tok_err['plain']:.5f}")
    log(f"  bigE ITM probabilities: fp32 {itm_want.tolist()}; bf16 ITM path "
        f"over the fp32 tokens {itm_path.tolist()}, max |d| {path_gap:.3e}; "
        f"the whole bf16 route {itm.tolist()}, max |d| {gap:.3e}")
    for name, c in cosines.items():
        if not c >= COSINE_MIN:
            raise AssertionError(f"bigE {name} cosine {c} < {COSINE_MIN}")
    if not tok_err["kernels"] <= TOWER_ERR_RATIO * tok_err["plain"]:
        raise AssertionError(f"bigE ViT token error on the kernel route "
                             f"{tok_err['kernels']} > {TOWER_ERR_RATIO} x the "
                             f"bf16 plain route's {tok_err['plain']}")
    if not path_gap <= ITM_PROB_TOL:
        raise AssertionError(f"bigE ITM path gap {path_gap} > {ITM_PROB_TOL}")
    del model, model32
    free_cuda()
    return dict(build_s=build_s, tower_params=n_vit, step_ms=step_ms,
                step_times_ms=times, samples_per_s=1e3 * S / step_ms,
                peak_memory_bytes=peak, resident_bytes=resident,
                fused_attn_proj_step_ms=statistics.median(times8),
                k8_vs_k5_cosine=k8_cos, folded_cosine=folded_cos,
                cosine=cosines, token_error=tok_err,
                itm_path_max_abs_diff=path_gap, itm_max_abs_diff=gap,
                paths=paths)


# ---------------------------------------------------------------------------
# phase 6b: MiCo on the OpenAI-CLIP ViT-L/14 tower (K3, or K9 with the flag)
# ---------------------------------------------------------------------------


def phase_clip(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.text import BertWordPieceTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MiCoConfig(vision_encoder_type="clip_vit_large_14_336px",
                     max_vision_sample_num=4, max_audio_sample_num=2)
    tower = cfg.vision_tower_config
    nlayers, nbert = tower.layers, cfg.bert_config.num_hidden_layers
    t0 = time.perf_counter()
    # one draw of the fp32 weights, by the card's generator; the bf16 model
    # is a copy of them
    model32 = MiCo(cfg, device="cuda", seed=0, init_device="cuda")
    model = copy.deepcopy(model32).to(dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0
    n_vit = sum(p.numel() for p in model.vision_encoder.parameters())
    log(f"phase CLIP: MiCo on the OpenAI-CLIP tower of "
        f"'{cfg.vision_encoder_type}' (ViT-L/{tower.patch_size} at "
        f"{tower.input_resolution} px: {nlayers} blocks, width {tower.width}, "
        f"{tower.heads} heads of {tower.width // tower.heads}, "
        f"{tower.seq_len} tokens; {n_vit / 1e6:.1f} M tower parameters; "
        f"BERT {nbert} layers), fp32 drawn and a bf16 copy made on the card "
        f"in {build_s:.1f} s")
    inp = omni_inputs()
    dev = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    tok = BertWordPieceTokenizer()
    enc = tok(CAPTIONS, max_length=TEXT_LEN)
    cap_ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    cap_mask = torch.from_numpy(enc["attention_mask"]).long().cuda()
    paths, routes = {}, {}
    for kernel, split in (("K3", False), ("K9", True)):
        tag = " (PACKED_CLS_SPLIT)" if split else ""
        fa.PACKED_CLS_SPLIT = split
        try:
            out = run_counted(fa, paths, "CLIP omni step" + tag,
                              lambda: omni_step(model, **dev),
                              **{kernel: nlayers})
            times = timed_runs(lambda: omni_step(model, **dev), runs=5)
            itm = run_counted(
                fa, paths, "CLIP ITM" + tag,
                lambda: itm_probs(model, dev["image"][:1], cap_ids, cap_mask),
                **{kernel: nlayers, "K2": nbert})
        finally:
            fa.PACKED_CLS_SPLIT = False
        for name in ("image", "video", "audio", "text"):
            check_unit(f"CLIP omni {name}{tag}", out[name])
        if itm.shape != (3,) or not torch.isfinite(itm).all():
            raise AssertionError(f"CLIP ITM probabilities{tag} {itm}")
        step_ms = statistics.median(times)
        routes[kernel] = dict(out=out, itm=itm, step_ms=step_ms, times=times)
        log(f"  CLIP omni step S={S}{tag} ({kernel} x {nlayers}): median "
            f"{step_ms:.2f} ms of {len(times)} "
            f"({[round(x, 2) for x in times]}), "
            f"{1e3 * S / step_ms:.2f} samples/s [{card}]; ITM "
            f"{[round(x, 5) for x in itm.tolist()]}")

    # the reference: the same one-sample inputs through the fp32 weights on
    # the plain routes (fp32 compute takes the plain twins), on the card
    model32.cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                      use_flash_attention=False)
    one = {k: v[:1] for k, v in dev.items()}
    want = run_counted(fa, paths, "CLIP fp32 plain reference",
                       lambda: omni_step(model32, **one))
    itm_want = itm_probs(model32, one["image"], cap_ids, cap_mask)
    result = dict(build_s=build_s, tower_params=n_vit, paths=paths)
    for kernel, r in routes.items():
        cos = {name: min_row_cosine(r["out"][name][:1], want[name])
               for name in ("image", "video", "audio", "text")}
        gap = (r["itm"] - itm_want).abs().max().item()
        log(f"  CLIP {kernel} route: card bf16 vs card fp32 cosine "
            f"{cos}; ITM max |d| {gap:.3e} (fp32 {itm_want.tolist()})")
        for name, c in cos.items():
            if not c >= COSINE_MIN:
                raise AssertionError(f"CLIP {kernel} route {name} cosine {c}")
        if not gap <= ITM_PROB_TOL:
            raise AssertionError(f"CLIP {kernel} route ITM gap {gap} > "
                                 f"{ITM_PROB_TOL}")
        result[kernel] = dict(step_ms=r["step_ms"], step_times_ms=r["times"],
                              samples_per_s=1e3 * S / r["step_ms"],
                              cosine=cos, itm_max_abs_diff=gap)
    del model, model32, routes
    free_cuda()
    return result


# ---------------------------------------------------------------------------
# phase 6c: EVA-CLIP zero-shot classification on EVA01-CLIP-g-14 (K1) and
# CLIP's RN50
# ---------------------------------------------------------------------------

# CIFAR-10's classes and two of CLIP's prompt templates: 20 prompts
ZS_CLASSES = ("airplane", "automobile", "bird", "cat", "deer", "dog", "frog",
              "horse", "ship", "truck")
ZS_TEMPLATES = ("a photo of a {}.", "a blurry photo of the {}.")
ZS_PATH = "EVA-CLIP zero-shot (EVA01-CLIP-g-14)"


def write_clip_merges(path: str, texts) -> None:
    """A CLIP-format merges file (a header line, one merge a line) whose
    merges build every word of `texts` left to right, its last unit ending
    in `</w>`; the words are ASCII, whose bytes are their own units."""
    from mico_tpu_torch.text.bpe import split_words

    merges = []
    for text in texts:
        for word in split_words(text.lower()):
            units = list(word)
            units[-1] += "</w>"
            left = units[0]
            for right in units[1:]:
                if (left, right) not in merges:
                    merges.append((left, right))
                left += right
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("".join(f"{a} {b}\n" for a, b in merges))


def scale_to_unit_map(mrn, rn, pixels) -> float:
    """Divides the first BN's scale by the RMS of the fp32 trunk's map on
    `pixels`, so the map reaching the attention pool has unit RMS, as a
    trained network's BNs keep it. At the drawn init (identity BNs, no
    conv bias) the trunk is positively homogeneous, so this scales the map
    and nothing else; drawn as is, the map has std ~183 and the pool's
    scores are near-argmax, which any rounding flips. Batch statistics in
    every BN instead make the random net chaotic: rounding grows block by
    block (`scripts/torch_rn50_precision.py` measures both). Returns the
    RMS."""
    rms = mrn.modified_resnet_trunk(rn, pixels).square().mean().sqrt()
    rn.stem_bn1.get("w").div_(rms)
    return rms.item()


def zero_shot(ct, model, pixels, tokenizer, dtype, impl):
    """(normalized image features, the classifier, softmax(logits))."""
    img = ct.clip_encode_image(model, pixels, compute_dtype=dtype,
                               attn_impl=impl)
    w = ct.build_zero_shot_classifier(model, ZS_CLASSES, ZS_TEMPLATES,
                                      tokenizer, compute_dtype=dtype)
    logits = img.float() @ w.T * model.logit_scale.float().exp()
    return img, w, torch.softmax(logits, dim=-1)


@torch.no_grad()
def phase_eva_clip(fa, card: str) -> dict:
    import os
    import tempfile

    from mico_tpu_torch.models import clip_text as ct
    from mico_tpu_torch.models import modified_resnet as mrn
    from mico_tpu_torch.text.bpe import ClipBpeTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    vcfg, tcfg, model32 = ct.create_model("EVA01-CLIP-g-14", seed=0,
                                          device="cuda")
    # the towers in bf16; logit_scale stays fp32, as JAX keeps it
    model = copy.deepcopy(model32)
    model.visual.to(bf16)
    model.text.to(bf16)
    build_s = time.perf_counter() - t0
    log(f"phase eva_clip: EVA01-CLIP-g-14 (image: {vcfg.layers} pre-norm "
        f"blocks, width {vcfg.width}, {vcfg.num_heads} heads of "
        f"{vcfg.head_dim}, {vcfg.seq_len} tokens, head to {vcfg.embed_dim}; "
        f"text: {tcfg.layers} layers, width {tcfg.width}, {tcfg.heads} "
        f"heads, context {tcfg.context_length}, projection to "
        f"{tcfg.output_dim}), fp32 drawn and a bf16 copy of the towers made "
        f"on the card in {build_s:.1f} s")
    prompts = [t.format(c) for c in ZS_CLASSES for t in ZS_TEMPLATES]
    with tempfile.TemporaryDirectory(prefix="mico_bpe_") as root:
        merges = os.path.join(root, "merges.txt")
        write_clip_merges(merges, prompts)
        tok = ClipBpeTokenizer(merges)
    ids = tok(prompts, tcfg.context_length)
    eot = ids.argmax(axis=1)
    if (ids.shape != (len(prompts), tcfg.context_length)
            or ids.max() != tok.eot_id or tok.eot_id >= tcfg.vocab_size
            or not (ids[np.arange(len(ids)), eot] == tok.eot_id).all()
            or not ((ids > 511) & (ids < tok.sot_id)).any(axis=1).all()):
        raise AssertionError(f"eva_clip: BPE ids {ids.tolist()}")
    log(f"  BPE (no regex) over {len(prompts)} prompts: ids {ids.shape}, "
        f"vocab {tok.vocab_size}, EOT {tok.eot_id}; '{prompts[0]}' -> "
        f"{ids[0, :eot[0] + 1].tolist()}")
    pixels = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (ZS_B, 3, vcfg.image_size, vcfg.image_size)).astype(np.float32)
    ).cuda()
    paths = {}
    img, w, probs = run_counted(
        fa, paths, ZS_PATH,
        lambda: zero_shot(ct, model, pixels, tok, bf16, "flash"),
        K1=vcfg.layers)
    img32, w32, probs32 = run_counted(
        fa, paths, "EVA-CLIP zero-shot fp32 plain reference",
        lambda: zero_shot(ct, model32, pixels, tok, torch.float32, "plain"))
    if (img.shape != (ZS_B, vcfg.embed_dim)
            or w.shape != (len(ZS_CLASSES), tcfg.output_dim)
            or probs.shape != (ZS_B, len(ZS_CLASSES))):
        raise AssertionError(f"eva_clip shapes {img.shape} {w.shape} "
                             f"{probs.shape}")
    # bf16 rows over their norm rounded to bf16 (2^-8 relative), as JAX
    norms = torch.linalg.vector_norm(img.float(), dim=-1)
    if not (torch.isfinite(img).all()
            and ((norms - 1).abs() <= 2 ** -7).all()):
        raise AssertionError(f"eva_clip image feature norms {norms.tolist()}")
    check_unit("eva_clip classifier", w)
    cos = {"image": min_row_cosine(img, img32),
           "classifier": min_row_cosine(w, w32)}
    gap = (probs - probs32).abs().max().item()
    top1 = (probs.argmax(-1) == probs32.argmax(-1)).float().mean().item()
    log(f"  zero-shot bf16 (K1 x {vcfg.layers}) vs fp32 plain: min cosine "
        f"{cos}; softmax max |d| {gap:.3e}; top-1 agreement {top1:.3f}")
    for name, c in cos.items():
        if not c >= COSINE_MIN:
            raise AssertionError(f"eva_clip {name} cosine {c} < {COSINE_MIN}")
    if not gap <= ITM_PROB_TOL:
        raise AssertionError(f"eva_clip probabilities gap {gap} > "
                             f"{ITM_PROB_TOL}")
    image_times = timed_runs(lambda: ct.clip_encode_image(
        model, pixels, compute_dtype=bf16), runs=5)
    text_times = timed_runs(lambda: ct.build_zero_shot_classifier(
        model, ZS_CLASSES, ZS_TEMPLATES, tok, compute_dtype=bf16), runs=5)
    del model, model32, img32, w32
    free_cuda()

    rcfg = mrn.ModifiedResNetConfig()
    rn32 = mrn.ModifiedResNet(rcfg, device="cuda", seed=0)
    map_rms = scale_to_unit_map(mrn, rn32, pixels)
    rn = copy.deepcopy(rn32).to(bf16)
    out = run_counted(fa, paths, "RN50 forward (ModifiedResNet)",
                      lambda: mrn.modified_resnet_forward(rn, pixels, bf16))
    if out.shape != (ZS_B, rcfg.output_dim) or not torch.isfinite(out).all():
        raise AssertionError(f"RN50 output {out.shape}")
    rn_cos = min_row_cosine(out, mrn.modified_resnet_forward(rn32, pixels))
    rn_times = timed_runs(
        lambda: mrn.modified_resnet_forward(rn, pixels, bf16), runs=5)
    log(f"  RN50 (layers {rcfg.layers}, width {rcfg.width}, {rcfg.heads} "
        f"heads, {rcfg.image_size} px; the drawn map's RMS {map_rms:.1f} "
        f"scaled to 1) B {ZS_B}, bf16 vs fp32 min cosine {rn_cos:.6f}")
    if not rn_cos >= COSINE_MIN:
        raise AssertionError(f"RN50 cosine {rn_cos} < {COSINE_MIN}")
    del rn, rn32
    free_cuda()
    image_ms, text_ms, rn_ms = (statistics.median(x) for x in
                                (image_times, text_times, rn_times))
    phase_s = time.perf_counter() - t_phase
    log(f"  eva_clip image pass B {ZS_B}: median {image_ms:.2f} ms of 5 "
        f"({[round(x, 2) for x in image_times]}), {1e3 * ZS_B / image_ms:.1f}"
        f" images/s; text pass {len(prompts)} prompts: median {text_ms:.2f} "
        f"ms ({[round(x, 2) for x in text_times]}), "
        f"{1e3 * len(prompts) / text_ms:.1f} prompts/s; RN50 B {ZS_B}: "
        f"median {rn_ms:.2f} ms ({[round(x, 2) for x in rn_times]}) [{card}]")
    log(f"  phase eva_clip: {phase_s:.1f} s")
    return dict(build_s=build_s, phase_s=phase_s, image_ms=image_ms,
                image_times_ms=image_times, images_per_s=1e3 * ZS_B / image_ms,
                text_ms=text_ms, text_times_ms=text_times,
                prompts_per_s=1e3 * len(prompts) / text_ms,
                rn50_ms=rn_ms, rn50_times_ms=rn_times, cosine=cos,
                prob_max_abs_diff=gap, top1_agreement=top1,
                rn50_cosine=rn_cos, rn50_map_rms=map_rms, paths=paths)


# ---------------------------------------------------------------------------
# phase 6d: MiCo on EVA02-CLIP-L/14 (RoPE, SwiGLU, sub-LN: K2 as the ViT's
# self-attention)
# ---------------------------------------------------------------------------

EVA02_TRAIN_STEPS = 3


def k2_device_split(fn, iters: int = 3) -> dict:
    """Device ms of one call of fn by torch.profiler, split into K2's
    kernels (the split kernel and its combine) and the rest, with the
    rest's six largest kernels by name."""
    by = device_time_ms(fn, iters=iters, warmup=1, by_kernel=True)
    if by is None:
        return dict(device_ms=None, k2_device_ms=None, other_device_ms=None,
                    top_other_ms={})
    k2 = sum(ms for name, ms in by.items()
             if "flash_kernel" in name or "combine_kernel" in name)
    total = sum(by.values())
    other = sorted(((ms, name) for name, ms in by.items()
                    if "flash_kernel" not in name
                    and "combine_kernel" not in name), reverse=True)
    return dict(device_ms=total, k2_device_ms=k2, other_device_ms=total - k2,
                top_other_ms={name[:90]: ms for ms, name in other[:6]})


def embed_cosines(what: str, out: dict, want: dict, itm, itm_want,
                  names=("image", "video", "audio", "text")) -> dict:
    """Each embedding's cosine to the fp32 reference (>= COSINE_MIN) and
    the ITM probabilities' gap (<= ITM_PROB_TOL)."""
    cos = {name: min_row_cosine(out[name][:1], want[name]) for name in names}
    gap = (itm - itm_want).abs().max().item()
    log(f"  {what}: card bf16 vs card fp32 cosine {cos}; ITM max |d| "
        f"{gap:.3e} (bf16 {itm.tolist()}, fp32 {itm_want.tolist()})")
    for name, c in cos.items():
        if not c >= COSINE_MIN:
            raise AssertionError(f"{what} {name} cosine {c} < {COSINE_MIN}")
    if not gap <= ITM_PROB_TOL:
        raise AssertionError(f"{what} ITM gap {gap} > {ITM_PROB_TOL}")
    return dict(cosine=cos, itm_max_abs_diff=gap)


def phase_eva02(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.text import BertWordPieceTokenizer
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train.workload import PRETRAIN_TASK, synthetic_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = MiCoConfig(vision_encoder_type="evaclip02_large",
                     max_vision_sample_num=4, max_audio_sample_num=2)
    eva = cfg.eva_config
    nlayers, nbert = eva.layers, cfg.bert_config.num_hidden_layers
    t0 = time.perf_counter()
    # one draw of the fp32 weights, by the card's generator; the bf16 model
    # is a copy of them
    model32 = MiCo(cfg, device="cuda", seed=0, init_device="cuda")
    model = copy.deepcopy(model32).to(dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0
    n_vit = sum(p.numel() for p in model.vision_encoder.parameters())
    log(f"phase EVA02: MiCo on EVA02-CLIP-L-14 ('{cfg.vision_encoder_type}': "
        f"{nlayers} pre-norm blocks, width {eva.width}, {eva.num_heads} heads "
        f"of {eva.head_dim}, SwiGLU {eva.mlp_hidden}, sub-LN, RoPE, "
        f"{eva.seq_len} tokens; {n_vit / 1e9:.3f} B tower parameters; BERT "
        f"{nbert} layers), fp32 drawn and a bf16 copy made on the card in "
        f"{build_s:.1f} s")
    inp = omni_inputs()
    dev = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    tok = BertWordPieceTokenizer()
    enc = tok(CAPTIONS, max_length=TEXT_LEN)
    cap_ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    cap_mask = torch.from_numpy(enc["attention_mask"]).long().cuda()
    paths = {}

    out = run_counted(fa, paths, "EVA02 omni step",
                      lambda: omni_step(model, **dev), K2=nlayers)
    for name in ("image", "video", "audio", "text"):
        check_unit(f"EVA02 omni {name}", out[name])
    torch.cuda.reset_peak_memory_stats()
    times = timed_runs(lambda: omni_step(model, **dev), runs=5)
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    split = k2_device_split(lambda: omni_step(model, **dev))
    log(f"  EVA02 omni step S={S} (K2 x {nlayers}): median {step_ms:.2f} ms "
        f"of {len(times)} ({[round(x, 2) for x in times]}), "
        f"{1e3 * S / step_ms:.2f} samples/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; device {ms_text(split['device_ms'], 2)} "
        f"ms a step, of it K2 {ms_text(split['k2_device_ms'], 2)} and the "
        f"rest {ms_text(split['other_device_ms'], 2)} [{card}]; the rest's "
        "largest kernels (ms a step): " + "; ".join(
            f"{k} {v:.2f}" for k, v in split["top_other_ms"].items()))

    itm = run_counted(
        fa, paths, "EVA02 ITM",
        lambda: itm_probs(model, dev["image"][:1], cap_ids, cap_mask),
        K2=nlayers + nbert)
    if itm.shape != (3,) or not torch.isfinite(itm).all():
        raise AssertionError(f"EVA02 ITM probabilities {itm}")

    pipe = EmbeddingPipeline(model, cfg, tok, batch_size=8, io_workers=4)
    try:
        if pipe.model.vision_encoder.blocks[0].get("inner_attn_ln_w") is not None:
            raise AssertionError("the served EVA02 copy kept its sub-LN")
        images = [inp["image"][i % S] for i in range(20)]
        images[5] = None
        feats = run_counted(
            fa, paths, "EVA02 _run 20 images",
            lambda: pipe._run(images, lambda a: a,
                              lambda m, x: pipe._embed_pixels(m, x, head="v")),
            K2=3 * nlayers)
    finally:
        pipe.close()
    check_run_20(pipe, feats, cfg)
    del pipe
    folded_cos = float(feats[0] @ out["image"][0].cpu().numpy())
    log(f"  EVA02 pipeline: folded vs canonical image cosine {folded_cos:.6f}")
    if not folded_cos >= COSINE_MIN:
        raise AssertionError(f"EVA02 folded pipeline cosine {folded_cos}")

    # the reference: the same one-sample inputs through the fp32 weights on
    # the plain routes, on the card
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                use_flash_attention=False)
    model32.cfg = cfg32
    one = {k: v[:1] for k, v in dev.items()}
    want = run_counted(fa, paths, "EVA02 fp32 plain reference",
                       lambda: omni_step(model32, **one))
    itm_want = itm_probs(model32, one["image"], cap_ids, cap_mask)
    gates = embed_cosines("EVA02", out, want, itm, itm_want)
    del model
    free_cuda()

    # training: three steps of the pretraining task on the fp32 weights
    # (bf16 compute), K2 forward under autograd and its plain backward
    model32.cfg = cfg
    opt = build_optimizer(model32, OptimConfig(num_train_steps=10))
    step = make_train_step(cfg, opt, PRETRAIN_TASK)
    batch = synthetic_batch(TRAIN_B, seed=0)
    losses, train_times = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(EVA02_TRAIN_STEPS):
        t0 = time.perf_counter()
        vals = run_counted(
            fa, paths, f"EVA02 train step {i + 1}",
            lambda: step(model32, batch, torch.Generator().manual_seed(1)),
            K2=2 * nlayers)
        train_times.append(1e3 * (time.perf_counter() - t0))
        losses.append({k: v.item() for k, v in vals.items()})
        bad = [k for k, v in losses[-1].items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"EVA02 train step {i + 1}: non-finite {bad}")
    train_peak = torch.cuda.max_memory_allocated()
    train_ms = statistics.median(train_times[1:])
    log(f"  EVA02 train steps B={TRAIN_B} ({PRETRAIN_TASK}): losses "
        f"{[round(x['loss_total'], 5) for x in losses]}, "
        f"{[round(x, 1) for x in train_times]} ms, median of the last "
        f"{EVA02_TRAIN_STEPS - 1} {train_ms:.1f} ms/step, peak memory "
        f"{train_peak / 2 ** 30:.2f} GiB [{card}]")
    del opt, step, batch
    free_cuda()

    # the gradient check: the same weights, bf16 on the kernel routes
    # against fp32 on the plain routes
    cfg16 = dataclasses.replace(cfg, bert_override=dataclasses.replace(
        cfg.bert_config, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0))
    runs = grad_runs(fa, model32, {
        "bf16": (cfg16, False),
        "fp32": (dataclasses.replace(cfg16, compute_dtype="float32",
                                     use_flash_attention=False), False)})
    got = runs["bf16"]["launches"]
    if got["K2"] == 0 or any(v for k, v in got.items() if k != "K2"):
        raise AssertionError(f"EVA02 bf16 gradient run launches {got}: K2 "
                             "alone expected")
    if any(runs["fp32"]["launches"].values()):
        raise AssertionError(f"EVA02 fp32 run launched kernels: "
                             f"{runs['fp32']['launches']}")
    grads = hold_grads(model32, "EVA02 bf16", runs["bf16"], runs["fp32"],
                       nlayers - 1)
    paths["EVA02 gradient check (bf16)"] = got
    del model32, runs
    free_cuda()
    return dict(build_s=build_s, tower_params=n_vit, step_ms=step_ms,
                step_times_ms=times, samples_per_s=1e3 * S / step_ms,
                peak_memory_bytes=peak, step_device=split,
                folded_cosine=folded_cos, **gates, train_losses=losses,
                train_times_ms=train_times, train_ms=train_ms,
                train_peak_memory_bytes=train_peak, gradient_check=grads,
                paths=paths)


# ---------------------------------------------------------------------------
# phase 6e: MiCo on Swin-B and VideoSwin-B (no kernel in the towers; K2 in
# ITM where the condition is long enough)
# ---------------------------------------------------------------------------

SWIN_TOWERS = ("swin_base_patch4_window7_224_22k", "videoswin_base")


def phase_swin(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.serve import EmbeddingPipeline
    from mico_tpu_torch.text import BertWordPieceTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = BertWordPieceTokenizer()
    enc = tok(CAPTIONS, max_length=TEXT_LEN)
    cap_ids = torch.from_numpy(enc["input_ids"]).long().cuda()
    cap_mask = torch.from_numpy(enc["attention_mask"]).long().cuda()
    inp = omni_inputs()
    nbert = MiCoConfig().bert_config.num_hidden_layers
    result, paths = {}, {}
    for vtype in SWIN_TOWERS:
        cfg = MiCoConfig(vision_encoder_type=vtype, max_vision_sample_num=4,
                         max_audio_sample_num=2)
        tower = cfg.vision_tower_config
        name = "VideoSwin" if vtype.startswith("videoswin") else "Swin"
        t0 = time.perf_counter()
        model32 = MiCo(cfg, device="cuda", seed=0)
        model = copy.deepcopy(model32).to(dtype=torch.bfloat16)
        build_s = time.perf_counter() - t0
        n_vit = sum(p.numel() for p in model.vision_encoder.parameters())
        log(f"phase swin: MiCo on {name}-B ('{vtype}': embed {tower.embed_dim},"
            f" depths {tower.depths}, heads {tower.num_heads}, window "
            f"{tower.window_size}; {n_vit / 1e6:.1f} M tower parameters), fp32 "
            f"drawn and a bf16 copy made on the card in {build_s:.1f} s")
        pipe = EmbeddingPipeline(model, cfg, tok, batch_size=8, io_workers=4)
        images = [inp["image"][i % S] for i in range(16)]
        videos = [inp["video"][i % S] for i in range(16)]
        torch.cuda.reset_peak_memory_stats()
        try:
            feats, ms = {}, {}
            for what, items in (("images", images), ("4-frame videos", videos)):
                fn = functools.partial(
                    pipe._run, items, lambda a: a,
                    lambda m, x: pipe._embed_pixels(m, x, head="v"))
                feats[what] = run_counted(fa, paths, f"{name} _run 16 {what}",
                                          fn)
                check_unit(f"{name} {what}", torch.from_numpy(feats[what]))
                ms[what] = statistics.median(timed_runs(fn, runs=3)) / 2
            text = run_counted(fa, paths, f"{name} embed_texts",
                               lambda: pipe.embed_texts(CAPTIONS))
        finally:
            pipe.close()
        peak = torch.cuda.max_memory_allocated()
        video = torch.from_numpy(inp["video"][:1]).cuda()
        image = torch.from_numpy(inp["image"][:1]).cuda()
        itm = run_counted(fa, paths, f"{name} ITM, 4-frame video",
                          lambda: itm_probs(model, video, cap_ids, cap_mask),
                          K2=nbert)
        itm_image = run_counted(
            fa, paths, f"{name} ITM, image",
            lambda: itm_probs(model, image, cap_ids, cap_mask))
        for probs in (itm, itm_image):
            if probs.shape != (3,) or not torch.isfinite(probs).all():
                raise AssertionError(f"{name} ITM probabilities {probs}")
        model32.cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                          use_flash_attention=False)

        def embed(m, x):
            f = m.contra_head("v", m.pool_vision_for_contra(
                m.forward_vision_encoder(x))).float()
            return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

        with torch.no_grad():
            want = {"image": embed(model32, image), "video": embed(model32,
                                                                   video)}
            seq = model32.forward_multimodal_encoder(cap_ids[:1],
                                                     cap_mask[:1])
            t32 = model32.contra_head("t", seq[:, 0]).float()
            want["text"] = t32 / torch.linalg.vector_norm(t32, dim=-1,
                                                          keepdim=True)
        itm_want = itm_probs(model32, video, cap_ids, cap_mask)
        out = {"image": torch.from_numpy(feats["images"][:1]).cuda(),
               "video": torch.from_numpy(feats["4-frame videos"][:1]).cuda(),
               "text": torch.from_numpy(text[:1]).cuda()}
        gates = embed_cosines(name, out, want, itm, itm_want,
                              names=("image", "video", "text"))
        log(f"  {name}: ms per embedded batch of 8: images "
            f"{ms['images']:.2f}, 4-frame videos {ms['4-frame videos']:.2f};"
            f" peak memory {peak / 2 ** 30:.2f} GiB; ITM image "
            f"{[round(x, 5) for x in itm_image.tolist()]} [{card}]")
        result[name] = dict(build_s=build_s, tower_params=n_vit,
                            batch_ms=ms, peak_memory_bytes=peak, **gates)
        del model, model32
        free_cuda()
    result["paths"] = paths
    return result


# ---------------------------------------------------------------------------
# phase 7: the pretraining step
# ---------------------------------------------------------------------------

TRAIN_B = 8                 # samples per step (4 frames + 2 audio slices each)
TRAIN_STEPS = 6
GRAD_B = 2
LOSS_RTOL = 2e-2            # card bf16 vs card fp32, per loss
GRAD_COSINE_MIN = 0.99


def k34_library(qkv, g, nh, scale):
    """SDPA on the split (B, H, L, D) views of the fused qkv: the forward,
    and a closure that runs its autograd backward alone."""
    import torch.nn.functional as F

    b, l, w3 = qkv.shape
    w = w3 // 3
    q, k, v = (x.detach().view(b, l, nh, w // nh).transpose(1, 2)
               .requires_grad_(True) for x in qkv.split(w, dim=-1))
    out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    go = g.view(b, l, nh, w // nh).transpose(1, 2)
    return (lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            lambda: torch.autograd.grad(out, (q, k, v), go,
                                        retain_graph=True))


def sdpa_bwd_backends(qkv, g, nh, scale) -> dict:
    """SDPA's autograd backward alone on the split (B, H, L, D) views of the
    fused qkv, as a closure for each backend that takes them (pinned with
    `torch.nn.attention.sdpa_kernel`): K4's yardsticks."""
    b, l, w3 = qkv.shape
    w = w3 // 3
    return sdpa_bwd_pinned(
        lambda: [x.view(b, l, nh, w // nh).transpose(1, 2)
                 for x in qkv.split(w, dim=-1)],
        g.view(b, l, nh, w // nh).transpose(1, 2), scale)


def sdpa_bwd_pinned(views, go, scale) -> dict:
    """SDPA's autograd backward alone for the output gradient go, one
    closure for each backend that takes the (q, k, v) `views()` gives
    (pinned with `torch.nn.attention.sdpa_kernel`): K4's and K6b's
    yardsticks."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        q, k, v = (x.detach().requires_grad_(True) for x in views())
        try:
            with sdpa_kernel([backend]):
                o = F.scaled_dot_product_attention(q, k, v, scale=scale)
                torch.autograd.grad(o, (q, k, v), go, retain_graph=True)
        except RuntimeError as e:
            log(f"  SDPA backward, {name}: does not take the shape "
                f"({str(e).splitlines()[0][:80]})")
            continue
        out[name] = (lambda o=o, q=q, k=k, v=v:
                     torch.autograd.grad(o, (q, k, v), go, retain_graph=True))
    return out


def k4_device(fa, fn) -> dict:
    """K4's device ms per call, in all and by launch (the rows' statistics
    and dQ, the columns' dK and dV)."""
    by = device_time_ms(fn, by_kernel=True)
    if by is None:
        return dict(device_ms=None, device_ms_by_launch=None)
    launches = {"rows": 0.0, "cols": 0.0}
    for name, ms in by.items():
        for key in launches:
            if f"k4_{key}" in name:
                launches[key] += ms
    return dict(device_ms=sum(by.values()), device_ms_by_launch=launches)


def phase_train_kernels(fa) -> list:
    gen = torch.Generator().manual_seed(3)
    errs = {"K3": [], "K4": []}
    inputs = {}
    log("phase train: K3 packed_attention / K4 packed_attention_bwd vs "
        "their plain versions")
    # the train pass, a ragged tail, rows of three key blocks and the
    # long-context step's pass (B 2 samples of 32 frames)
    for b, l, nh, d in ((4 * TRAIN_B, 257, 16, 88), (3, 50, 4, 64),
                        (2, 600, 16, 88), (LONG_B * 32, 257, 16, 88)):
        w = nh * d
        # unit std: q.k sums D products of unit variance, so the scaled
        # scores (times D^-0.5) have std ~1 and the softmax is far from flat
        qkv = torch.randn(b, l, 3 * w, generator=gen).to("cuda",
                                                         torch.bfloat16)
        g = torch.randn(b, l, w, generator=gen).to("cuda", torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        scale = d ** -0.5
        want = fa.packed_attention_bwd_plain(q, k, v, g, nh, scale)
        # both layouts: column slices of the fused qkv (row stride 3W) and
        # three contiguous tensors (row stride W)
        for layout, (qq, kk, vv) in (
                ("column slices", (q, k, v)),
                ("three tensors", (q.contiguous(), k.contiguous(),
                                   v.contiguous()))):
            errs["K3"].append(compare(
                f"K3 qkv ({b}, {l}, {3 * w}) H={nh} D={d}, {layout}",
                fa.packed_attention(qq, kk, vv, nh, scale),
                fa.packed_attention_plain(qq, kk, vv, nh, scale),
                rel_mean=REL_MEAN_ERR_MAX))
            got = fa.packed_attention_bwd(qq, kk, vv, g, nh, scale)
            for name, x, y in zip(("dq", "dk", "dv"), got, want):
                errs["K4"].append(compare(
                    f"K4 {name} ({b}, {l}, {w}), {layout}", x, y,
                    rel_mean=REL_MEAN_ERR_MAX))
            del got
        dqkv = torch.empty_like(qkv)
        fa.packed_attention_bwd(q, k, v, g, nh, scale, dqkv)
        errs["K4"].append(compare(
            f"K4 dqkv ({b}, {l}, {3 * w})", dqkv, torch.cat(want, dim=-1),
            rel_mean=REL_MEAN_ERR_MAX))
        del want, dqkv
        inputs[(b, l)] = (qkv, g, nh, d)
    qkv, g, nh, d = inputs[(4 * TRAIN_B, 257)]
    b, l, w3 = qkv.shape
    w, scale = w3 // 3, d ** -0.5
    q, k, v = qkv.chunk(3, dim=-1)
    sdpa_fwd, sdpa_bwd = k34_library(qkv, g, nh, scale)
    att_flops = 4 * b * nh * l * l * d
    rows = []
    bms, by = bound_ms(att_flops, 2 * (qkv.numel() + b * l * w))

    def k3():
        return fa.packed_attention(q, k, v, nh, scale)

    # ... and at CLIP-L/14's serving pass, (112, 257, 3 x 16 x 64)
    clip_qkv = torch.randn(S * 7, 257, 3 * 1024, generator=gen).to(
        "cuda", torch.bfloat16)
    cq, ck, cv = clip_qkv.chunk(3, dim=-1)
    clip_fwd, _ = k34_library(clip_qkv, cq.contiguous(), 16, 0.125)
    clip_bms, clip_by = bound_ms(4 * S * 7 * 16 * 257 * 257 * 64,
                                 2 * (clip_qkv.numel() + S * 7 * 257 * 1024))
    rows.append(dict(
        name="K3 packed_attention", route="cuda",
        source="mico_tpu_torch/csrc/packed_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:1135",
        shape=f"qkv ({b}, {l}, {w3}) bf16 column slices, H={nh}, D={d}",
        ms=cuda_time_ms(k3),
        plain_ms=cuda_time_ms(
            lambda: fa.packed_attention_plain(q, k, v, nh, scale),
            iters=5, warmup=1),
        library_ms=cuda_time_ms(sdpa_fwd),
        bound_ms=bms, bound_by=by, flops=att_flops,
        bytes=2 * (qkv.numel() + b * l * w),
        device_ms=device_time_ms(k3),
        library_device_ms=device_time_ms(sdpa_fwd),
        clip_shape=f"qkv ({S * 7}, 257, 3072) bf16 column slices, H=16, "
                   "D=64",
        clip_device_ms=device_time_ms(
            lambda: fa.packed_attention(cq, ck, cv, 16, 0.125)),
        clip_library_device_ms=device_time_ms(clip_fwd),
        clip_bound_ms=clip_bms, clip_bound_by=clip_by))
    row = rows[-1]
    log(f"  K3 device ms: train pass {ms_text(row['device_ms'])} (SDPA "
        f"{ms_text(row['library_device_ms'])}); CLIP-L "
        f"{ms_text(row['clip_device_ms'])} (SDPA "
        f"{ms_text(row['clip_library_device_ms'])}, bound "
        f"{clip_bms:.4f} by {clip_by})")
    nbytes = 2 * (qkv.numel() + g.numel()) + 2 * qkv.numel()
    bms, by = bound_ms(2.5 * att_flops, nbytes)
    dqkv = torch.empty_like(qkv)

    def k4():
        return fa.packed_attention_bwd(q, k, v, g, nh, scale, dqkv)

    lib = {name: device_time_ms(fn) for name, fn in
           sdpa_bwd_backends(qkv, g, nh, scale).items()}
    measured = {n: ms for n, ms in lib.items() if ms is not None}
    # ... and at the long-context step's pass, (64, 257, 4224)
    lqkv, lg, _, _ = inputs[(LONG_B * 32, 257)]
    lq, lk, lv = lqkv.chunk(3, dim=-1)
    ldqkv = torch.empty_like(lqkv)
    long_dev = k4_device(fa, lambda: fa.packed_attention_bwd(
        lq, lk, lv, lg, nh, scale, ldqkv))
    long_lib = {name: device_time_ms(fn) for name, fn in
                sdpa_bwd_backends(lqkv, lg, nh, scale).items()}
    rows.append(dict(
        name="K4 packed_attention_bwd", route="cuda",
        source="mico_tpu_torch/csrc/packed_attn_bwd.cu",
        replaces="mico_tpu/ops/flash_attention.py:1059",
        shape=f"qkv ({b}, {l}, {w3}), g ({b}, {l}, {w}) bf16 -> dqkv",
        ms=cuda_time_ms(k4),
        plain_ms=cuda_time_ms(
            lambda: fa.packed_attention_bwd_plain(q, k, v, g, nh, scale),
            iters=5, warmup=1),
        library_ms=cuda_time_ms(sdpa_bwd),
        bound_ms=bms, bound_by=by, flops=2.5 * att_flops, bytes=nbytes,
        **k4_device(fa, k4),
        library_device_ms_by_backend=lib,
        library_device_ms=min(measured.values()) if measured else None,
        long_shape=f"qkv {tuple(lqkv.shape)}, g {tuple(lg.shape)} bf16",
        long_device_ms=long_dev["device_ms"],
        long_device_ms_by_launch=long_dev["device_ms_by_launch"],
        long_library_device_ms_by_backend=long_lib))
    row = rows[-1]
    log(f"  K4 device ms: train pass {ms_text(row['device_ms'])} "
        f"({row['device_ms_by_launch']}), SDPA backward by backend {lib}; "
        f"long-context pass {ms_text(row['long_device_ms'])} "
        f"({row['long_device_ms_by_launch']}), SDPA {long_lib}")
    return finish_rows(rows, errs)


def phase_cls_kernels(fa) -> list:
    """K9 against its plain version at ViT-g's train pass, CLIP-L/14's
    serving pass, bigE's head width and a 385-token sequence; timed at the
    CLIP-L pass (and the train pass) beside K3 on the same input, the plain
    version, SDPA and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(5)
    errs = {"K9": []}
    log("phase cls: K9 packed_qkv_cls_attention vs "
        "packed_qkv_cls_attention_plain")
    inputs = {}
    for b, l, nh, d in ((4 * TRAIN_B, 257, 16, 88), (112, 257, 16, 64),
                        (8, 257, 16, 112), (2, 385, 4, 64), (1, 513, 4, 88)):
        # unit std, as for K3: scores of std ~1, a softmax far from flat
        qkv = torch.randn(b, l, 3 * nh * d, generator=gen).to(
            "cuda", torch.bfloat16)
        scale = d ** -0.5
        errs["K9"].append(compare(
            f"K9 qkv ({b}, {l}, {3 * nh * d}) H={nh} D={d}",
            fa.packed_qkv_cls_attention(qkv, nh, scale),
            fa.packed_qkv_cls_attention_plain(qkv, nh, scale),
            rel_mean=REL_MEAN_ERR_MAX))
        inputs[(b, l, nh, d)] = qkv

    def timed(qkv, nh, d) -> dict:
        b, l, w3 = qkv.shape
        w, scale = w3 // 3, d ** -0.5
        q, k, v = qkv.chunk(3, dim=-1)
        qh, kh, vh = (x.view(b, l, nh, d).transpose(1, 2) for x in (q, k, v))
        flops = 4 * b * nh * l * l * d
        nbytes = 2 * (qkv.numel() + b * l * w)
        bms, by = bound_ms(flops, nbytes)

        def k9():
            return fa.packed_qkv_cls_attention(qkv, nh, scale)

        def k3():
            return fa.packed_attention(q, k, v, nh, scale)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

        return dict(
            ms=cuda_time_ms(k9), k3_ms=cuda_time_ms(k3),
            plain_ms=cuda_time_ms(
                lambda: fa.packed_qkv_cls_attention_plain(qkv, nh, scale),
                iters=5, warmup=1),
            library_ms=cuda_time_ms(sdpa),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
            device_ms=device_time_ms(k9), k3_device_ms=device_time_ms(k3),
            library_device_ms=device_time_ms(sdpa))

    clip = timed(inputs[(112, 257, 16, 64)], 16, 64)
    train = timed(inputs[(4 * TRAIN_B, 257, 16, 88)], 16, 88)
    row = dict(name="K9 packed_qkv_cls_attention", route="cuda",
               source="mico_tpu_torch/csrc/packed_cls_attn.cu",
               replaces="mico_tpu/ops/flash_attention.py:809",
               shape="qkv (112, 257, 3072) bf16, H=16, D=64", **clip,
               train_shape=f"qkv ({4 * TRAIN_B}, 257, 4224) bf16, H=16, D=88",
               **{f"train_{k}": v for k, v in train.items()})
    finish_rows([row], errs)
    log(f"  K9 vs K3 on the same input: CLIP-L {clip['ms']:.4f} vs "
        f"{clip['k3_ms']:.4f} ms; ViT-g train pass {train['ms']:.4f} vs "
        f"{train['k3_ms']:.4f} ms (plain {train['plain_ms']:.4f}, SDPA "
        f"{train['library_ms']:.4f}, bound {train['bound_ms']:.4f} by "
        f"{train['bound_by']})")
    log(f"  K9 device ms: CLIP-L {ms_text(clip['device_ms'])} (K3 "
        f"{ms_text(clip['k3_device_ms'])}, SDPA "
        f"{ms_text(clip['library_device_ms'])}); train pass "
        f"{ms_text(train['device_ms'])} (K3 {ms_text(train['k3_device_ms'])}"
        f", SDPA {ms_text(train['library_device_ms'])})")
    return [row]


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_steps(fa, card: str) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train.workload import (PRETRAIN_TASK,
                                               pretrain_step_flops,
                                               synthetic_batch)

    cfg = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    t0 = time.perf_counter()
    model = MiCo(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, OptimConfig(num_train_steps=10))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase train: MiCo-ViT-g fp32 master weights ({n_params / 1e9:.3f} B "
        f"parameters), bf16 compute, drop-path {cfg.eva_config.drop_path_rate}, "
        f"BERT dropout {cfg.bert_config.hidden_dropout_prob}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    step = make_train_step(cfg, opt, PRETRAIN_TASK)
    batch = synthetic_batch(TRAIN_B, seed=0)
    nlayers = cfg.eva_config.layers
    paths, losses, times = {}, [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        # the same draws every step: a fixed batch and fixed masks, so the
        # loss must fall as the weights fit them
        out = run_counted(
            fa, paths, f"train step {i + 1}",
            lambda: step(model, batch, torch.Generator().manual_seed(1)),
            K3=2 * nlayers, K4=2 * nlayers)
        times.append(1e3 * (time.perf_counter() - t0))
        vals = {k: v.item() for k, v in out.items()}
        losses.append(vals)
        log(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}"
                                            for k, v in vals.items())
            + f"; {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    for i, vals in enumerate(losses):
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {i + 1}: non-finite {bad}")
    if not losses[-1]["loss_total"] < losses[1]["loss_total"]:
        raise AssertionError(
            f"loss_total at step {TRAIN_STEPS} {losses[-1]['loss_total']} is "
            f"not below step 2's {losses[1]['loss_total']}")
    step_ms = statistics.median(times[-4:])
    # one more step under torch.profiler: the device's busy time against
    # the median step, the synthetic batch's idle share
    _, busy, _ = profiled(
        lambda: step(model, batch, torch.Generator().manual_seed(1)))
    idle = None if busy is None else 1.0 - busy / step_ms
    flops = pretrain_step_flops(cfg, TRAIN_B)
    result = dict(
        task=PRETRAIN_TASK, batch=TRAIN_B, losses=losses, step_times_ms=times,
        step_ms=step_ms, samples_per_s=1e3 * TRAIN_B / step_ms,
        model_flops_per_step=flops,
        model_tflops_per_s=flops / (step_ms * 1e-3) / 1e12,
        peak_memory_bytes=peak, n_params=n_params, busy_ms=busy,
        idle_share=idle,
        launches_per_step=paths[f"train step {TRAIN_STEPS}"], paths=paths)
    log(f"  train step B={TRAIN_B}: median {step_ms:.2f} ms of the last 4 "
        f"({[round(x, 2) for x in times]}), {result['samples_per_s']:.3f} "
        f"samples/s, {result['model_tflops_per_s']:.2f} model TFLOP/s "
        f"({flops / 1e12:.3f} TFLOP/step), peak memory {peak / 2 ** 30:.2f} GiB; "
        f"one more step under torch.profiler: busy {ms_text(busy, 2)} ms, "
        f"idle share {'not measured' if idle is None else f'{idle:.3f}'} "
        f"of the median [{card}]")
    del model, opt, step, batch
    free_cuda()
    return result


def grad_runs(fa, model, cfgs: dict) -> dict:
    """{label: losses, launches and gradients} of `PRETRAIN_TASK`'s summed
    losses at GRAD_B with every rate 0 and the draws injected (seed 1's
    batch, seed 2's masks, negatives the next sample), for each label's
    (config, PACKED_CLS_SPLIT) on the same weights."""
    from mico_tpu_torch.train.masker import mask_tokens
    from mico_tpu_torch.train.objectives import Draws, task_losses
    from mico_tpu_torch.train.workload import PRETRAIN_TASK, synthetic_batch

    batch = synthetic_batch(GRAD_B, seed=1)
    masked = mask_tokens(batch["caption_ids"], 0.6,
                         torch.Generator().manual_seed(2))
    flip = torch.arange(GRAD_B, device="cuda").roll(1)
    runs = {}
    for label, (cfg, split) in cfgs.items():
        model.cfg = cfg
        model.zero_grad(set_to_none=True)
        fa.reset_launch_counts()
        fa.PACKED_CLS_SPLIT = split
        try:
            losses = task_losses(model, cfg, batch, PRETRAIN_TASK,
                                 torch.Generator().manual_seed(0),
                                 draws=Draws(masks=[masked],
                                             negatives=[(flip, flip)]))
            sum(losses.values()).backward()
        finally:
            fa.PACKED_CLS_SPLIT = False
        torch.cuda.synchronize()
        runs[label] = dict(
            losses={k: v.item() for k, v in losses.items()},
            launches=fa.launch_counts(),
            grads={n: p.grad.detach().float().clone()
                   for n, p in model.named_parameters()
                   if p.grad is not None})
        model.zero_grad(set_to_none=True)
        log(f"  gradient check, card {label}: losses {runs[label]['losses']}, "
            f"launches {runs[label]['launches']}")
    return runs


def hold_grads(model, label: str, a: dict, b: dict, last: int) -> dict:
    """Run `a` against the fp32 run `b`: each loss within LOSS_RTOL, the
    gradient cosine >= GRAD_COSINE_MIN per optimizer group and for the
    first and last block's qkv_w (`last` its index)."""
    from mico_tpu_torch.train.optim import param_group_labels

    def cos(x, y):
        return torch.nn.functional.cosine_similarity(
            x.double().flatten(), y.double().flatten(), dim=0).item()

    for k, v in b["losses"].items():
        if not abs(a["losses"][k] - v) <= LOSS_RTOL * abs(v):
            raise AssertionError(f"{k}: {label} {a['losses'][k]} vs fp32 {v}")
    labels = param_group_labels(model)
    groups = {}
    for n, _ in model.named_parameters():
        if n in a["grads"]:
            groups.setdefault(labels[n], []).append(n)
    group_cos = {g: cos(torch.cat([a["grads"][n].flatten() for n in ns]),
                        torch.cat([b["grads"][n].flatten() for n in ns]))
                 for g, ns in groups.items()}
    held = {n: cos(a["grads"][n], b["grads"][n]) for n in (
        "vision_encoder.blocks.0.qkv_w",
        f"vision_encoder.blocks.{last}.qkv_w")}
    per_tensor = {n: cos(a["grads"][n], b["grads"][n])
                  for n in a["grads"] if b["grads"][n].abs().max() > 0}
    worst = min(per_tensor, key=per_tensor.get)
    log(f"  gradient cosine {label} vs fp32 by group {group_cos}; "
        f"{held}; lowest per tensor {worst} {per_tensor[worst]:.6f}")
    for name, c in {**group_cos, **held}.items():
        if not c >= GRAD_COSINE_MIN:
            raise AssertionError(f"{label} gradient cosine {name} {c} < "
                                 f"{GRAD_COSINE_MIN}")
    return dict(losses=a["losses"], launches=a["launches"],
                group_cosine=group_cos, qkv_w_cosine=held,
                lowest_tensor=worst, lowest_tensor_cosine=per_tensor[worst])


def phase_train_grads(fa) -> dict:
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo

    base = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    eva = dataclasses.replace(base.eva_config, drop_path_rate=0.0)
    bert = dataclasses.replace(base.bert_config, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    cfg16 = dataclasses.replace(base, eva_override=eva, bert_override=bert)
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32",
                                use_flash_attention=False)
    model = MiCo(cfg16, device="cuda", seed=0).requires_grad_(True)
    runs = grad_runs(fa, model, {"bf16": (cfg16, False),
                                 "bf16 K9": (cfg16, True),
                                 "fp32": (cfg32, False)})
    b = runs["fp32"]
    passes = 2 * base.eva_config.layers        # the vision and audio passes
    a, k9 = runs["bf16"], runs["bf16 K9"]["launches"]
    if a["launches"]["K3"] == 0 or a["launches"]["K4"] == 0 \
            or a["launches"]["K2"] == 0:
        raise AssertionError(f"bf16 run missed a kernel: {a['launches']}")
    if (k9["K9"], k9["K3"], k9["K4"]) != (passes, 0, passes):
        raise AssertionError(f"bf16 K9 run launches {k9}: expected K9 "
                             f"{passes}, K3 0, K4 {passes}")
    if any(v for v in b["launches"].values()):
        raise AssertionError(f"fp32 run launched kernels: {b['launches']}")
    last = base.eva_config.layers - 1
    out = {label: hold_grads(model, label, runs[label], b, last)
           for label in ("bf16", "bf16 K9")}
    del model, runs
    free_cuda()
    return dict(losses_fp32=b["losses"], **{
        ("bf16" if label == "bf16" else "bf16_k9"): r
        for label, r in out.items()})


# ---------------------------------------------------------------------------
# phase 8: long-context caption training (K6, K6b)
# ---------------------------------------------------------------------------

LONG_B = 2                  # the JAX bench's 16 cut to what one card holds
LONG_STEPS = 5
LSE_TOL = 1e-3


def long_qkvg(gen, b, h, lq, lk, d, layout: str):
    """Unit-std bf16 q, k, v and an output gradient g of (B, H, L, D);
    layout "bert": each a (B, L, H, D) tensor viewed as (B, H, L, D), k and
    v column slices of one (B, Lk, 2, H, D) projection, as BERT's
    cross-attention makes them; "contiguous": (B, H, L, D) tensors."""
    def r(*s):
        return torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)

    if layout == "contiguous":
        return r(b, h, lq, d), r(b, h, lk, d), r(b, h, lk, d), r(b, h, lq, d)
    kv = r(b, lk, 2, h, d)
    return (r(b, lq, h, d).transpose(1, 2), kv[:, :, 0].transpose(1, 2),
            kv[:, :, 1].transpose(1, 2), r(b, lq, h, d).transpose(1, 2))


def check_lse(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  {name}: lse max|d| {err:.3e}")
    if not err <= LSE_TOL:
        raise AssertionError(f"{name}: lse max |d| {err} > {LSE_TOL}")


def sdpa_library(q, k, v, g, scale):
    """SDPA forward on K6's inputs, and a closure that runs its autograd
    backward alone (K6b's yardstick)."""
    import torch.nn.functional as F

    qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, scale=scale)
    return (lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            lambda: torch.autograd.grad(out, (qq, kk, vv), g,
                                        retain_graph=True))


def phase_long_kernels(fa) -> list:
    gen = torch.Generator().manual_seed(5)
    errs = {"K6": [], "K6b": []}
    log("phase long-context: K6 kv_tiled_attention / K6b "
        "kv_tiled_attention_bwd vs their plain versions")
    pad = torch.ones(LONG_B, 8224)
    pad[1, 6000:] = 0
    pad_bias = ((1.0 - pad) * -10000.0)[:, None, None, :].cuda()
    cases = [("(2, 12, 128, 8224, 64) BERT layout, no bias",
              (LONG_B, 12, 128, 8224, 64), "bert", None),
             ("(2, 12, 128, 8224, 64) BERT layout, (2, 1, 1, 8224) padding "
              "bias", (LONG_B, 12, 128, 8224, 64), "bert", pad_bias),
             ("(1, 2, 160, 9000, 88) ragged, no bias", (1, 2, 160, 9000, 88),
              "contiguous", None)]
    # cases that cross split boundaries of the keys besides those (K6: 11
    # and 29 splits, the last ragged; K6b: 5 and 47): one query row, and a
    # padding bias that masks every key of K6's fourth split and of the K6b
    # split that holds its first key
    sms = fa._sm_count(torch.cuda.current_device())
    _, _, nsplit, per = fa.flash_plan(128, 8224, LONG_B * 12, 64, 1, sms)
    bsplit, bper = fa.k6b_plan(8224, LONG_B * 12, sms)
    if nsplit < 4 or bsplit < 2:
        raise AssertionError(f"K6 takes {nsplit} splits, K6b {bsplit} at the "
                             "long-context shape: the masked split case "
                             "checks nothing")
    k0, k1 = 3 * 64 * per, 4 * 64 * per
    b0 = k0 // (64 * bper) * 64 * bper
    b1 = min(8224, b0 + 64 * bper)
    pad = torch.ones(LONG_B, 8224)
    pad[:, min(k0, b0):max(k1, b1)] = 0
    pad[1, 6000:] = 0
    cases += [("(2, 12, 1, 8224, 64) one query row, no bias",
               (LONG_B, 12, 1, 8224, 64), "contiguous", None),
              (f"(2, 12, 128, 8224, 64) BERT layout, a (2, 1, 1, 8224) bias "
               f"masking all of K6's split 4 of {nsplit} (keys {k0}.."
               f"{k1 - 1}) and K6b's split {b0 // (64 * bper) + 1} of "
               f"{bsplit} (keys {b0}..{b1 - 1})",
               (LONG_B, 12, 128, 8224, 64), "bert",
               ((1.0 - pad) * -10000.0)[:, None, None, :].cuda())]
    timed = None
    for what, shape, layout, bias in cases:
        q, k, v, g = long_qkvg(gen, *shape, layout)
        scale = shape[-1] ** -0.5
        got = fa.kv_tiled_attention(q, k, v, bias, scale)
        got_s, lse = fa.kv_tiled_attention(q, k, v, bias, scale,
                                           return_lse=True)
        want, want_lse = fa.kv_tiled_attention_plain(q, k, v, bias, scale,
                                                     return_lse=True)
        what = f"{what}, {plan_label(fa, q, k, bias)}"
        errs["K6"].append(compare(f"K6 {what}", got, want,
                                  rel_mean=REL_MEAN_ERR_MAX))
        errs["K6"].append(compare(f"K6 with LSE {what}", got_s, want,
                                  rel_mean=REL_MEAN_ERR_MAX))
        check_lse(f"K6 {what}", lse, want_lse)
        # K6b and its plain version on the same inputs: K6's lse and o
        delta = (g.float() * got_s.float()).sum(dim=-1, keepdim=True)
        grads = fa.kv_tiled_attention_bwd(q, k, v, g, lse, delta, bias, scale)
        wants = fa.kv_tiled_attention_bwd_plain(q, k, v, g, lse, delta, bias,
                                                scale)
        for name, x, y in zip(("dq", "dk", "dv"), grads, wants):
            errs["K6b"].append(compare(f"K6b {name} {what}", x, y,
                                       rel_mean=REL_MEAN_ERR_MAX))
        del got, got_s, want, want_lse, grads, wants
        if timed is None:
            timed = (q, k, v, g, lse, delta.contiguous(), scale)
    q, k, v, g, lse, delta, scale = timed
    b, h, lq, d = q.shape
    lk = k.shape[2]
    shape = (f"q ({b}, {h}, {lq}, {d}), k/v ({b}, {h}, {lk}, {d}) bf16 "
             f"strided views of (B, L, H, D), no bias")
    sdpa_fwd, sdpa_bwd = sdpa_library(q, k, v, g, scale)
    flops = 4 * b * h * lq * lk * d
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    rows = []
    bms, by = bound_ms(flops, nbytes)

    def k6():
        return fa.kv_tiled_attention(q, k, v, None, scale, return_lse=True)

    def k6_no_lse():
        return fa.kv_tiled_attention(q, k, v, None, scale)

    rows.append(dict(
        name="K6 kv_tiled_attention", route="cuda",
        source="mico_tpu_torch/csrc/kv_tiled_attn.cu",
        replaces="mico_tpu/ops/flash_attention.py:286",
        shape=shape + "; with LSE, as the training forward runs it",
        ms=cuda_time_ms(k6), ms_no_lse=cuda_time_ms(k6_no_lse),
        device_ms_no_lse=device_time_ms(k6_no_lse),
        plain_ms=cuda_time_ms(lambda: fa.kv_tiled_attention_plain(
            q, k, v, None, scale, return_lse=True), iters=5, warmup=1),
        library_ms=cuda_time_ms(sdpa_fwd),
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
        **split_timing(fa, k6, sdpa_fwd, q, k, bms)))
    # s, dp, dq, dk and dv; q, k, v, g, lse and delta in, dq, dk, dv out
    flops = 10 * b * h * lq * lk * d
    nbytes = (2 * 2 * (q.numel() + k.numel() + v.numel() + g.numel())
              - 2 * g.numel() + 4 * (lse.numel() + delta.numel()))
    bms, by = bound_ms(flops, nbytes)

    def k6b():
        return fa.kv_tiled_attention_bwd(q, k, v, g, lse, delta, None, scale)

    by_launch = stage_device_ms(k6b, {"pass": "k6b_kernel",
                                      "combine": "combine_kernel"})
    dev = (None if None in by_launch.values()
           else sum(by_launch.values()))
    lib = {name: device_time_ms(fn) for name, fn in sdpa_bwd_pinned(
        lambda: (q, k, v), g, scale).items()}
    measured = {n: ms for n, ms in lib.items() if ms is not None}
    bsplit, bper = fa.k6b_plan(lk, b * h, fa._sm_count(q.device.index))
    rows.append(dict(
        name="K6b kv_tiled_attention_bwd", route="cuda",
        source="mico_tpu_torch/csrc/kv_tiled_attn_bwd.cu",
        replaces="mico_tpu/ops/flash_attention.py:486",
        shape=shape + "; g, lse, delta -> dq, dk, dv",
        ms=cuda_time_ms(k6b), device_ms=dev, device_ms_by_launch=by_launch,
        splits=bsplit, chunks_per_split=bper,
        plain_ms=cuda_time_ms(lambda: fa.kv_tiled_attention_bwd_plain(
            q, k, v, g, lse, delta, None, scale), iters=5, warmup=1),
        # the fastest pinned backend's device ms; null where the profiler
        # recorded none (the unpinned call's event ms is another kind of
        # number, kept apart)
        library_ms=min(measured.values()) if measured else None,
        library_device_ms_by_backend=lib,
        library_unpinned_ms=cuda_time_ms(sdpa_bwd),
        roofline_share=None if dev is None else bms / dev,
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes))
    log(f"  K6 without LSE: {rows[0]['ms_no_lse']:.4f} ms (device "
        f"{ms_text(rows[0]['device_ms_no_lse'])})")
    log_split_timing("K6 with LSE", rows[0])
    log(f"  K6b device ms {ms_text(dev)} ({by_launch}; {bsplit} splits of "
        f"{bper} chunks), SDPA backward by backend {lib}")
    return finish_rows(rows, errs)


def phase_long_train(fa, card: str) -> dict:
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.train.objectives import task_losses
    from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train.workload import (LONG_CONTEXT_CAPTION_LEN,
                                               LONG_CONTEXT_FRAMES,
                                               LONG_CONTEXT_TASK,
                                               long_context_batch,
                                               long_context_config,
                                               pretrain_step_flops)

    cfg = long_context_config()
    t0 = time.perf_counter()
    model = MiCo(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, OptimConfig(num_train_steps=10))
    nvit = cfg.eva_config.layers
    nbert = cfg.bert_config.num_hidden_layers
    remat = cfg.checkpointing if cfg.bert_checkpointing is None \
        else cfg.bert_checkpointing
    log(f"phase long-context train: {LONG_CONTEXT_TASK} at B={LONG_B}, "
        f"{LONG_CONTEXT_FRAMES} frames ({LONG_CONTEXT_FRAMES * 257} condition "
        f"tokens), {LONG_CONTEXT_CAPTION_LEN}-token captions; fp32 master "
        f"weights, bf16 compute, drop-path {cfg.eva_config.drop_path_rate}, "
        f"BERT hidden dropout {cfg.bert_config.hidden_dropout_prob}, "
        f"probability dropout 0, BERT remat {remat}; built in "
        f"{time.perf_counter() - t0:.1f} s")
    step = make_train_step(cfg, opt, LONG_CONTEXT_TASK)
    batch = long_context_batch(LONG_B, seed=0)
    # per step: the ViT's training pass over 64 frames (K3, K4 per block);
    # BERT's causal 128 x 128 self-attention on K2 (plain backward) and its
    # cross-attention over 8,224 tokens on K6 with LSE and K6b per layer
    # (K6 twice under BERT remat, whose recompute runs the forward again)
    want = dict(K3=nvit, K4=nvit, K2=nbert, K6=nbert * (2 if remat else 1),
                K6b=nbert)
    paths, losses, times = {}, [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(LONG_STEPS):
        t0 = time.perf_counter()
        out = run_counted(
            fa, paths, f"long-context train step {i + 1}",
            lambda: step(model, batch, torch.Generator().manual_seed(1)),
            **want)
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append({k: v.item() for k, v in out.items()})
        log(f"  step {i + 1}: " + ", ".join(f"{k} {v:.5f}"
                                            for k, v in losses[-1].items())
            + f"; {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    for i, vals in enumerate(losses):
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"long-context step {i + 1}: non-finite {bad}")
    if not losses[-1]["loss_total"] < losses[1]["loss_total"]:
        raise AssertionError(
            f"long-context loss_total at step {LONG_STEPS} "
            f"{losses[-1]['loss_total']} is not below step 2's "
            f"{losses[1]['loss_total']}")
    with torch.no_grad():
        nograd = run_counted(
            fa, paths, "long-context no-grad forward",
            lambda: task_losses(model, cfg, batch, LONG_CONTEXT_TASK,
                                torch.Generator().manual_seed(1)),
            K3=nvit, K2=nbert, K6=nbert)
    nograd = {k: v.item() for k, v in nograd.items()}
    if not all(np.isfinite(v) for v in nograd.values()):
        raise AssertionError(f"long-context no-grad losses {nograd}")
    step_ms = statistics.median(times[-3:])
    flops = pretrain_step_flops(cfg, LONG_B, LONG_CONTEXT_FRAMES, 0,
                                LONG_CONTEXT_CAPTION_LEN, LONG_CONTEXT_TASK)
    result = dict(
        task=LONG_CONTEXT_TASK, batch=LONG_B, frames=LONG_CONTEXT_FRAMES,
        caption_len=LONG_CONTEXT_CAPTION_LEN, bert_remat=remat,
        losses=losses, step_times_ms=times, step_ms=step_ms,
        samples_per_s=1e3 * LONG_B / step_ms, model_flops_per_step=flops,
        model_tflops_per_s=flops / (step_ms * 1e-3) / 1e12,
        peak_memory_bytes=peak, nograd_losses=nograd,
        launches_per_step=paths[f"long-context train step {LONG_STEPS}"],
        paths=paths)
    log(f"  long-context step B={LONG_B}: median {step_ms:.2f} ms of the last "
        f"3 ({[round(x, 2) for x in times]}), {result['samples_per_s']:.3f} "
        f"samples/s, {result['model_tflops_per_s']:.2f} model TFLOP/s "
        f"({flops / 1e12:.3f} TFLOP/step), peak memory "
        f"{peak / 2 ** 30:.2f} GiB [{card}]; no-grad forward {nograd}")
    del opt, step, batch
    free_cuda()
    result["gradient_check"] = phase_long_grads(fa, model)
    del model
    free_cuda()
    return result


def phase_long_grads(fa, model) -> dict:
    """BERT's gradients of the caption loss at B = 1 over condition tokens
    computed once (the tower in bf16, detached): the bf16 kernel route (K2,
    K6, K6b) against the card's fp32 plain route, every rate 0."""
    from mico_tpu_torch.models import mico as mico_mod
    from mico_tpu_torch.train.masker import mask_tokens
    from mico_tpu_torch.train.objectives import caption_loss
    from mico_tpu_torch.train.optim import param_group_labels
    from mico_tpu_torch.train.workload import (long_context_batch,
                                               long_context_config)

    base = long_context_config(hidden_dropout_prob=0.0)
    cfg16 = dataclasses.replace(base, eva_override=dataclasses.replace(
        base.eva_config, drop_path_rate=0.0))
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32",
                                use_flash_attention=False)
    batch = long_context_batch(1, seed=1)
    model.cfg = cfg16
    with torch.no_grad():
        cond = mico_mod.condition_input(
            model, mico_mod.forward_vision_encoder(model,
                                                   batch["vision_pixels"]),
            "vision").detach()
    masked = mask_tokens(batch["caption_ids"], 0.6,
                         torch.Generator().manual_seed(2))
    names = [n for n, _ in model.named_parameters() if n.startswith("bert.")]
    runs = {}
    for label, cfg in (("bf16", cfg16), ("fp32", cfg32)):
        model.cfg = cfg
        model.zero_grad(set_to_none=True)
        fa.reset_launch_counts()
        loss = caption_loss(model, cfg, cond, batch["caption_ids"],
                            batch["caption_mask"],
                            train_rng=torch.Generator().manual_seed(0),
                            masked=masked)
        loss.backward()
        torch.cuda.synchronize()
        params = dict(model.named_parameters())
        runs[label] = dict(loss=loss.item(), launches=fa.launch_counts(),
                           grads={n: params[n].grad.detach().float().clone()
                                  for n in names
                                  if params[n].grad is not None})
        log(f"  long-context gradient check, card {label}: loss "
            f"{runs[label]['loss']:.6f}, launches {runs[label]['launches']}")
    model.zero_grad(set_to_none=True)
    a, b = runs["bf16"], runs["fp32"]
    nbert = base.bert_config.num_hidden_layers
    if not (a["launches"]["K6"] == a["launches"]["K6b"] == nbert
            and a["launches"]["K2"] == nbert):
        raise AssertionError(f"bf16 run missed a kernel: {a['launches']}")
    if any(b["launches"].values()):
        raise AssertionError(f"fp32 run launched kernels: {b['launches']}")
    if not abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"]):
        raise AssertionError(f"loss_cap: bf16 {a['loss']} vs fp32 {b['loss']}")

    def cos(x, y):
        return torch.nn.functional.cosine_similarity(
            x.double().flatten(), y.double().flatten(), dim=0).item()

    labels = param_group_labels(model)
    groups = {}
    for n in names:
        if n in a["grads"]:
            groups.setdefault(labels[n], []).append(n)
    group_cos = {g: cos(torch.cat([a["grads"][n].flatten() for n in ns]),
                        torch.cat([b["grads"][n].flatten() for n in ns]))
                 for g, ns in groups.items()}
    held = {n: cos(a["grads"][n], b["grads"][n]) for n in (
        f"bert.layers.{i}.{w}" for i in (0, nbert - 1)
        for w in ("xq_w", "xk_w", "xv_w"))}
    per_tensor = {n: cos(a["grads"][n], b["grads"][n]) for n in a["grads"]
                  if b["grads"][n].abs().max() > 0}
    worst = min(per_tensor, key=per_tensor.get)
    log(f"  long-context gradient cosine bf16 vs fp32 by BERT group "
        f"{group_cos}; cross-attention {held}; lowest per tensor {worst} "
        f"{per_tensor[worst]:.6f}")
    for name, c in {**group_cos, **held}.items():
        if not c >= GRAD_COSINE_MIN:
            raise AssertionError(f"long-context gradient cosine {name} {c} < "
                                 f"{GRAD_COSINE_MIN}")
    return dict(loss_bf16=a["loss"], loss_fp32=b["loss"],
                launches_bf16=a["launches"], group_cosine=group_cos,
                cross_qkv_w_cosine=held, lowest_tensor=worst,
                lowest_tensor_cosine=per_tensor[worst])


# ---------------------------------------------------------------------------
# phase 9: P1, the fused ViT MLP of the matmul probe
# ---------------------------------------------------------------------------


def mlp_probe():
    """`scripts/torch_mlp_probe.py`, the P1 probe, imported by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / "torch_mlp_probe.py"
    spec = importlib.util.spec_from_file_location("torch_mlp_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mlp_inputs(gen, m, k, n):
    """x unit-std and W1, W2 at std 1/sqrt(fan-in): the MLP branch is as
    large as x, so a fault in it cannot hide under the residual (on the
    probe's 0.02-scale data x dominates the output)."""
    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen, device="cuda")).to(
            torch.bfloat16)

    return rnd(m, k), rnd(k, n, s=k ** -0.5), rnd(n, k, s=n ** -0.5)


def mlp_library(x, w1, w2):
    """One PyTorch call per stage: torch.matmul, F.gelu (tanh), torch.matmul,
    the residual add; the (M, N) hidden goes through HBM."""
    import torch.nn.functional as F

    return torch.matmul(F.gelu(torch.matmul(x, w1), approximate="tanh"),
                        w2) + x


def check_branch(name: str, got, want, x) -> dict:
    """The MLP branch alone, out - x, under the relative mean gate."""
    gb, wb = got.float() - x.float(), want.float() - x.float()
    err = (gb - wb).abs().mean().item()
    ref = wb.abs().mean().item()
    log(f"  {name} branch (out - x): mean|d| {err:.3e} (mean |ref| {ref:.3e})")
    if not err <= REL_MEAN_ERR_MAX * ref:
        raise AssertionError(f"{name} branch: mean |d| {err:.3e} > "
                             f"{REL_MEAN_ERR_MAX} * {ref:.3e}")
    return {"branch_mean_abs_err": err, "branch_mean_abs_ref": ref}


def phase_mlp(fa, card: str) -> tuple:
    """P1 against its plain version at the probe's geometry and a ragged
    small one, timed beside the plain version, the library route and the
    bound; then the probe's chain of 8 calls, counted from 0."""
    from mico_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

    probe = mlp_probe()
    gen = torch.Generator(device="cuda").manual_seed(9)
    errs = {"P1": []}
    log("phase mlp: P1 fused_mlp vs fused_mlp_plain")
    branch = {}
    for m, k, n in ((probe.M, probe.K, probe.N), (200, 128, 256)):
        x, w1, w2 = mlp_inputs(gen, m, k, n)
        want = fused_mlp_plain(x, w1, w2)
        got = fused_mlp(x, w1, w2)
        name = f"P1 ({m}, {k}) x ({k}, {n})"
        errs["P1"].append(compare(name, got, want, rel_mean=REL_MEAN_ERR_MAX))
        branch[name] = check_branch(name, got, want, x)
        if m == probe.M:
            timed = (x, w1, w2)
        del want, got
    x, w1, w2 = timed
    m, k = x.shape
    n = w1.shape[1]
    flops = 4 * m * k * n
    nbytes = 2 * (2 * x.numel() + w1.numel() + w2.numel())
    bms, by = bound_ms(flops, nbytes)

    def p1():
        return fused_mlp(x, w1, w2)

    stages = stage_device_ms(p1, {"fc1": "epi_gemm_kernel<1>",
                                  "fc2": "epi_gemm_kernel<2>"})
    dev = None if None in stages.values() else sum(stages.values())
    row = dict(
        name="P1 fused_mlp", route="cuda",
        source="mico_tpu_torch/csrc/fused_mlp.cu",
        replaces="scripts/pallas_matmul_probe.py:33",
        shape=f"x ({m}, {k}), W1 ({k}, {n}), W2 ({n}, {k}) bf16",
        ms=cuda_time_ms(p1, iters=5, warmup=1), device_ms=dev,
        device_ms_by_launch=stages,
        plain_ms=cuda_time_ms(lambda: fused_mlp_plain(x, w1, w2), iters=3,
                              warmup=1),
        library_ms=cuda_time_ms(lambda: mlp_library(x, w1, w2), iters=5,
                                warmup=1),
        library_device_ms=device_time_ms(lambda: mlp_library(x, w1, w2),
                                         iters=10),
        roofline_share=None if dev is None else bms / dev,
        bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes, branch=branch)
    finish_rows([row], errs)
    log(f"  P1 device ms {ms_text(dev)} ({stages}), library route device "
        f"{ms_text(row['library_device_ms'])}")
    del x, w1, w2, timed

    paths = {}
    x, w1s, w2s = probe.probe_inputs()
    out = run_counted(fa, paths, "MLP probe chain",
                      lambda: probe.mlp_chain(x, w1s, w2s), P1=probe.DEPTH)
    if out.shape != x.shape or not torch.isfinite(out).all():
        raise AssertionError(f"MLP probe chain: {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    chain_ms = cuda_time_ms(lambda: probe.mlp_chain(x, w1s, w2s), iters=3,
                            warmup=1)
    chain_flops = probe.DEPTH * flops
    log(f"  MLP probe chain ({probe.DEPTH} P1 calls at the probe's 0.02 "
        f"scale): {chain_ms:.3f} ms, {chain_flops / chain_ms / 1e9:.1f} "
        f"TF/s [{card}]; launches {paths['MLP probe chain']}")
    del x, w1s, w2s, out
    free_cuda()
    return [row], dict(chain_ms=chain_ms, paths=paths)


# ---------------------------------------------------------------------------
# phase 10: the train/test entry, `python -m mico_tpu_torch.run`
# ---------------------------------------------------------------------------

RUN_ITEMS = 32              # clips of the synthetic corpus (and one corrupt)
RUN_FRAMES = 8              # JPEG frames written per clip; 4 are sampled
RUN_B = 8
RUN_STEPS, RUN_RESUME_STEPS = 4, 6
# the run trains and tests at ViT-g width with this many of its 40 blocks,
# as phases dp, tp, pp and captioner (the testing run's 1e-6 hold passes
# there since its retrieval val set has no corrupt clip; PR 22)
RUN_LAYERS = 10
# the resume check runs at ViT-g width with this many blocks: a full-depth
# model and optimizer file is 14.4 GB, and saving and loading it again
# would take the phase well past 150 s on an H100 (PERF.md)
RUN_RESUME_LAYERS = 4
# valid_steps = num_train_steps // valid_freq - 1 (`data/build.py`, as
# JAX's): evaluations at steps 3 and 4, then at step 6 alone
RUN_VALID_FREQ, RUN_RESUME_VALID_FREQ = 1, 2
RUN_WORDS = ("a man woman dog cat is are skiing running playing singing on "
             "in the a snowy sunny park street beach day night with red "
             "blue ball guitar two three children").split()
# the train step of the full-width run whose device time torch.profiler
# takes (steps 2 and 3, before the first evaluation, time the loop)
RUN_PROFILED_STEP = 4


def write_run_corpus(root, seed: int, items: int = RUN_ITEMS,
                     refs: bool = False) -> dict:
    """An `annoindexed` corpus under root: `items` clips, each a directory
    of RUN_FRAMES cv2 JPEG frames of 256 x 320 and a 5 s 16 kHz 16-bit WAV,
    with a caption (with `refs`, a list of 2 or 3 reference captions), a
    question and answers (a list for every other clip), and one clip whose
    frames are corrupt JPEGs (the dataset resamples past it); all drawn
    from `seed`. `val_txt` lists the clips without the corrupt one: a
    dataset draws a corrupt clip's stand-in from its seeded RNG (JAX's
    `_resample` too), so a run's later evaluations and a fresh testing run
    would score different galleries (ROADMAP.md queue 3, PR 22)."""
    import os
    import wave

    import cv2

    rng = np.random.default_rng(seed)
    frames_dir = os.path.join(root, "frames")
    wav_dir = os.path.join(root, "wav")
    os.makedirs(frames_dir)
    os.makedirs(wav_dir)
    y, x = np.mgrid[0:256, 0:320]
    annos = []

    def words(n):
        return " ".join(rng.choice(RUN_WORDS, n))

    for i in range(items + 1):
        cid = f"clip{i:03d}" if i < items else "corrupt"
        os.makedirs(os.path.join(frames_dir, cid))
        for k in range(RUN_FRAMES):
            path = os.path.join(frames_dir, cid, f"{k:04d}.jpg")
            if cid == "corrupt":
                with open(path, "wb") as f:
                    f.write(b"\xff\xd8 not a jpeg")
                continue
            base = np.stack([(x + 9 * i + 3 * k) % 256, (y * 2 + 5 * i) % 256,
                             (x + y + 11 * k) % 256], -1)
            img = (base + rng.integers(-30, 31, base.shape)).clip(0, 255)
            cv2.imwrite(path, img.astype(np.uint8))
        t = np.arange(5 * 16000) / 16000
        wav = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)
               + 0.05 * rng.standard_normal(t.shape))
        with wave.open(os.path.join(wav_dir, f"{cid}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((wav * 32767).clip(-32768, 32767).astype(np.int16)
                          .tobytes())
        caption = ([words(8) for _ in range(2 + i % 2)] if refs
                   else words(8))
        annos.append({"video_id": cid, "caption": caption,
                      "question": words(5) + "?",
                      "answer": ([words(1), words(1), words(2)] if i % 2
                                 else words(1)),
                      "question_id": i})
    txt = os.path.join(root, "annos.json")
    with open(txt, "w") as f:
        json.dump(annos, f)
    val_txt = os.path.join(root, "annos_val.json")
    with open(val_txt, "w") as f:
        json.dump([a for a in annos if a["video_id"] != "corrupt"], f)
    return dict(txt=txt, val_txt=val_txt, vision=frames_dir, audio=wav_dir)


def run_argv(corpus: dict, out: str) -> list:
    """`python -m mico_tpu_torch.run`'s arguments for
    configs/pretrain-omni.json on the synthetic corpus: the data paths, `video_frame`, B 8, and a
    `ret%tva` (ITM re-rank on; its clips without the corrupt one, so the
    testing run scores the gallery of the run's last evaluation) and a
    `cap%tv` val set (the corrupt clip kept: evaluation resamples past it);
    the shared tower's audio at the ViT's 224 x 224."""
    clip = {"type": "annoindexed", "txt": corpus["txt"],
            "vision": corpus["vision"], "vision_format": "video_frame",
            "vision_sample_num": 4, "n_workers": 4, "batch_size": RUN_B}
    audio = {"audio": corpus["audio"], "audio_sample_num": 2}
    train = [{**clip, **audio, "training": True, "name": "synthetic",
              "task": "ret%tva_cap%tva"}]
    val = [{**clip, **audio, "training": False, "name": "synthetic",
            "task": "ret%tva", "txt": corpus.get("val_txt", corpus["txt"])},
           {**clip, "training": False, "name": "synthcap", "task": "cap%tv"}]
    return ["--config", "configs/pretrain-omni.json", "--output_dir", out,
            "--device", "cuda", "--data_cfg.train", json.dumps(train),
            "--data_cfg.val", json.dumps(val), "run_cfg.seed=0",
            "run_cfg.first_eval=false", "run_cfg.itm_rerank=true",
            "run_cfg.log_every=1", "model_cfg.audio_melbins=224",
            "model_cfg.audio_target_length=224"]


class Patches:
    """Attribute (or dict entry) replacements undone on close."""

    def __init__(self):
        self.undo = []

    def set(self, obj, name, value):
        if isinstance(obj, dict):
            self.undo.append((obj, name, obj[name]))
            obj[name] = value
            return
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def close(self):
        for obj, name, value in reversed(self.undo):
            if isinstance(obj, dict):
                obj[name] = value
            else:
                setattr(obj, name, value)
        self.undo = []


def profiled(fn, cpu: bool = True):
    """(fn(), device busy ms, wall ms) of one call under torch.profiler:
    busy is the sum of the kernels' own device time (None when none was
    recorded). cpu=False traces the device alone: a step of many small ops
    (the SCST update's decode under grad) ran 25x slower with the host's
    ops traced too."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=([ProfilerActivity.CPU] if cpu else [])
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if (dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            busy += dev_us / 1e3
    return out, (busy or None), wall


class RunProbe:
    """Instruments `run.main` from outside: each stage (train step,
    evaluation, save, load) runs with the launch counts set to 0 just
    before it and is held to its own counts (K3 and K4 2 x blocks a train
    step; K1 one per block a ViT pass and K2 12 a re-rank pass in an
    evaluation; nothing in saves and loads); every plain twin of the
    kernel wrappers is watched for calls on card tensors; saves and loads
    are timed with the host's peak RSS over them."""

    def __init__(self, fa, layers: int):
        import mico_tpu_torch.evaluation as ev
        import mico_tpu_torch.models.mico as mico_mod
        import mico_tpu_torch.pipeline as pipeline
        import mico_tpu_torch.run as run_mod
        import mico_tpu_torch.train.checkpoints as ckpt
        from mico_tpu_torch.data import AnnoIndexedDataset

        self.fa, self.layers = fa, layers
        self.stages, self.events, self.tokens = [], [], []
        self.plain_on_card = {}
        self.vit = self.rerank = self.n_steps = 0
        self.profile_step = None
        self.model = None
        self.resamples = 0
        self.p = p = Patches()

        def counting(module, name, attr):
            fn = getattr(module, name)

            def wrapped(*a, **kw):
                setattr(self, attr, getattr(self, attr) + 1)
                return fn(*a, **kw)
            p.set(module, name, wrapped)

        counting(mico_mod, "forward_vision_encoder", "vit")
        counting(ev, "compute_slice_scores", "rerank")
        resample = AnnoIndexedDataset._resample

        def resampled(ds, *a, **kw):
            self.resamples += 1
            return resample(ds, *a, **kw)
        p.set(AnnoIndexedDataset, "_resample", resampled)
        for name in dir(fa):
            if name.endswith("_plain") and callable(getattr(fa, name)):
                p.set(fa, name, self._watch_plain(name, getattr(fa, name)))
        generate = ev.generate

        def gen(*a, **kw):
            out = generate(*a, **kw)
            self.tokens.append(out)
            return out
        p.set(ev, "generate", gen)

        make_step = pipeline.make_train_step

        def make_train_step(cfg, optimizer, task, **kw):
            step = make_step(cfg, optimizer, task, **kw)

            def counted(model, batch, generator, draws=None):
                self.model = model
                self.n_steps += 1

                def call():
                    return step(model, batch, generator, draws)
                n = 2 * self.layers
                if self.n_steps != self.profile_step:
                    return self.stage("train step", call, K3=n, K4=n)
                out, busy, wall = self.stage(
                    "train step", lambda: profiled(call), K3=n, K4=n)
                self.stages[-1].update(busy_ms=busy, profiled_ms=wall)
                return out
            return counted
        p.set(pipeline, "make_train_step", make_train_step)

        evaluate = ev.evaluation_registry["evaluation_mm"]

        def evaluation_mm(evaluator, loaders, run_cfg, step):
            self.vit = self.rerank = 0
            out = self.stage("eval", lambda: evaluate(evaluator, loaders,
                                                      run_cfg, step),
                             expect=lambda: {"K1": self.layers * self.vit,
                                             "K2": 12 * self.rerank})
            self.stages[-1].update(step=step, vit_passes=self.vit,
                                   rerank_passes=self.rerank, metrics=out)
            return out
        p.set(ev.evaluation_registry, "evaluation_mm", evaluation_mm)

        for cls, name in ((ckpt.ModelSaver, "save"),
                          (ckpt.ModelSaver, "save_best")):
            p.set(cls, name, self._timed(name, getattr(cls, name)))
        for name in ("resume_latest", "load_latest_opt_state",
                     "load_from_pretrained_dir", "mico_from_jax"):
            p.set(run_mod, name, self._timed(name, getattr(run_mod, name)))
        commit, remove = ckpt._commit, ckpt._remove

        def committed(tmp, final):
            self.events.append(("commit", final.rsplit("/", 1)[-1]))
            commit(tmp, final)

        def removed(path):
            self.events.append(("remove", path.rsplit("/", 1)[-1]))
            remove(path)
        p.set(ckpt, "_commit", committed)
        p.set(ckpt, "_remove", removed)

    def _watch_plain(self, name, fn):
        def watched(*a, **kw):
            if any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in list(a) + list(kw.values())):
                self.plain_on_card[name] = self.plain_on_card.get(name, 0) + 1
            return fn(*a, **kw)
        return watched

    def _timed(self, name, fn):
        def timed(*a, **kw):
            rss = RssPeak()
            out = self.stage(name, lambda: fn(*a, **kw))
            peak = rss.close()
            self.stages[-1].update(rss_start=rss.start, rss_peak=peak)
            return out
        return timed

    def stage(self, kind, fn, expect=None, **want):
        self.fa.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = self.fa.launch_counts()
        want = expect() if expect else want
        full = {k: want.get(k, 0) for k in got}
        self.stages.append(dict(kind=kind, seconds=seconds, launches=got,
                                expected=full))
        if set(want) - set(got) or got != full:
            raise AssertionError(f"run {kind}: launches {got}, expected "
                                 f"{full}")
        return out

    def close(self):
        self.p.close()


def phase_run(fa, card: str, train_step: dict) -> dict:
    """`mico_tpu_torch.run.main` on configs/pretrain-omni.json at full
    width (ViT-g cut to RUN_LAYERS blocks) over a corpus on disk: train 4
    steps with evaluations and saves, resume to step 6, then test from the
    run directory."""
    import os
    import shutil
    import tempfile

    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.run import main as run_main

    layers = RUN_LAYERS
    cut = dict(MiCoConfig().eva_config.__dict__, layers=layers)
    root = tempfile.mkdtemp(prefix="mico_run_")
    try:
        t0 = time.perf_counter()
        corpus = write_run_corpus(root, seed=0)
        log(f"phase run: wrote {RUN_ITEMS} clips + 1 corrupt ({RUN_FRAMES} "
            f"JPEG frames of 256x320 and a 5 s WAV each) in "
            f"{time.perf_counter() - t0:.1f} s")
        out = os.path.join(root, "out")
        argv = run_argv(corpus, out) + [
            f"model_cfg.eva_override={json.dumps(cut)}"]
        probe = RunProbe(fa, layers)
        probe.profile_step = RUN_PROFILED_STEP
        try:
            result = run_entry(probe, run_main, argv, out, layers, card,
                               train_step)
        finally:
            probe.close()
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()


def stage_lines(stages: list, record: dict) -> None:
    waits = {s["step"]: s["data_wait_s"] for s in record["steps"]}
    steps = [s for s in stages if s["kind"] == "train step"]
    for s, st in zip(steps, record["steps"]):
        s.update(step=st["step"], data_wait_s=waits[st["step"]],
                 losses=st["losses"])
    for s in stages:
        extra = ""
        if s["kind"] == "train step":
            extra = f"{s['step']}: data wait {s['data_wait_s']:.4f} s, step"
        elif s["kind"] == "eval":
            extra = (f"step {s['step']}: {s['vit_passes']} ViT passes, "
                     f"{s['rerank_passes']} re-rank passes,")
        if "rss_peak" in s:
            extra += (f" RSS {s['rss_start'] / 2**30:.2f} -> peak "
                      f"{s['rss_peak'] / 2**30:.2f} GiB,")
        log(f"  {s['kind']} {extra} {s['seconds']:.3f} s; launches "
            f"{ {k: v for k, v in s['launches'].items() if v} }")


def check_run_dir(out: str, step: int, files: list) -> None:
    import os

    for name in (f"model_step_{step}.npz", f"optimizer_step_{step}.npz",
                 "best_video_r1_synthetic.npz"):
        if name not in files:
            raise AssertionError(f"run: {name} missing from {files}")
    if not os.path.exists(os.path.join(out, "log", "hps.json")):
        raise AssertionError("run: log/hps.json missing")


def run_entry(probe, run_main, argv, out, layers, card, train_step) -> dict:
    """The full-width training run, the testing run from its directory,
    then the resume check at ViT-g width with RUN_RESUME_LAYERS blocks."""
    import os

    import mico_tpu_torch.run as run_mod
    from mico_tpu_torch.config import MiCoConfig

    def ckpt_files(d):
        return sorted(os.listdir(os.path.join(d, "ckpt")))

    # -- training: 4 steps, evaluations and saves at steps 3 and 4 --
    t0 = time.perf_counter()
    rec = run_main(argv + [f"run_cfg.num_train_steps={RUN_STEPS}",
                           f"run_cfg.valid_freq={RUN_VALID_FREQ}"])
    train_s = time.perf_counter() - t0
    first = list(probe.stages)
    log(f"  training run: {train_s:.1f} s (model, {RUN_STEPS} steps, "
        f"evaluations, saves)")
    stage_lines(first, rec)
    files = ckpt_files(out)
    log(f"  ckpt/: {files}")
    check_run_dir(out, RUN_STEPS, files)
    probe.model = None
    free_cuda()

    # -- testing from the run directory --
    probe.stages.clear()
    t0 = time.perf_counter()
    logs = run_main(argv + ["run_cfg.mode=testing", "--pretrain_dir", out,
                            "--output_dir", out + "_test"])
    test_s = time.perf_counter() - t0
    third = list(probe.stages)
    log(f"  testing run from {os.path.basename(out)}: {test_s:.1f} s")
    stage_lines(third, {"steps": []})
    free_cuda()

    # -- resume: a run of 4 steps and its resume to 6, at ViT-g width with
    # RUN_RESUME_LAYERS blocks (the run's saves and loads are timed above)
    cut = dict(MiCoConfig().eva_config.__dict__, layers=RUN_RESUME_LAYERS)
    out_cut = out + "_resume"
    argv_cut = [a if a != out else out_cut for a in argv] + [
        f"model_cfg.eva_override={json.dumps(cut)}"]
    log(f"  resume check: cut to ViT-g width with {RUN_RESUME_LAYERS} "
        f"blocks (the {layers}-block run's saves and loads above)")
    probe.layers = RUN_RESUME_LAYERS
    probe.profile_step = None
    probe.stages.clear()
    rec_c = run_main(argv_cut + [f"run_cfg.num_train_steps={RUN_STEPS}",
                                 f"run_cfg.valid_freq={RUN_VALID_FREQ}"])
    cut_first = list(probe.stages)
    stage_lines(cut_first, rec_c)
    check_run_dir(out_cut, RUN_STEPS, ckpt_files(out_cut))
    saved = {k: v.detach().clone()
             for k, v in probe.model.state_dict().items()}
    probe.model = None
    probe.stages.clear()
    probe.events.clear()
    loaded = {}
    load = run_mod.resume_latest

    def resume_and_compare(output_dir, m):
        step = load(output_dir, m)
        loaded["equal"] = all(torch.equal(v, saved[k])
                              for k, v in m.state_dict().items())
        loaded["step"] = step
        return step
    run_mod.resume_latest = resume_and_compare
    try:
        t0 = time.perf_counter()
        rec2 = run_main(argv_cut + [
            f"run_cfg.num_train_steps={RUN_RESUME_STEPS}",
            f"run_cfg.valid_freq={RUN_RESUME_VALID_FREQ}",
            "run_cfg.resume=true"])
        resume_s = time.perf_counter() - t0
    finally:
        run_mod.resume_latest = load
    del saved
    probe.model = None
    second = list(probe.stages)
    log(f"  resume run: {resume_s:.1f} s (load, steps 5-6, evaluation, "
        f"save; {RUN_RESUME_LAYERS} blocks)")
    stage_lines(second, rec2)
    files2 = ckpt_files(out_cut)
    ev = list(probe.events)
    log(f"  ckpt/: {files2}; commits and removals {ev}")
    if rec2["start_step"] != RUN_STEPS or rec2["end_step"] != RUN_RESUME_STEPS:
        raise AssertionError(f"resume: steps {rec2['start_step']} -> "
                             f"{rec2['end_step']}")
    if loaded.get("step") != RUN_STEPS or not loaded.get("equal"):
        raise AssertionError(f"resume: loaded step {loaded.get('step')}, "
                             f"weights bitwise equal {loaded.get('equal')}")
    if (f"model_step_{RUN_RESUME_STEPS}.npz" not in files2
            or any(f.startswith((f"model_step_{RUN_STEPS}",
                                 f"optimizer_step_{RUN_STEPS}"))
                   for f in files2)):
        raise AssertionError(f"resume: ckpt/ {files2}")
    for prefix in ("model", "optimizer"):
        c = ev.index(("commit", f"{prefix}_step_{RUN_RESUME_STEPS}.npz"))
        r = ev.index(("remove", f"{prefix}_step_{RUN_STEPS}.npz"))
        if not c < r:
            raise AssertionError(f"{prefix}_step_{RUN_STEPS} removed before "
                                 f"step {RUN_RESUME_STEPS} was committed: {ev}")

    # -- checks --
    all_steps = rec["steps"] + rec_c["steps"] + rec2["steps"]
    for s in all_steps:
        bad = [k for k, v in s["losses"].items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"run step {s['step']}: non-finite {bad}")
    last_eval = [s for s in first if s["kind"] == "eval"][-1]["metrics"]
    evals = [s for s in first + third + cut_first + second
             if s["kind"] == "eval"]
    for s in evals:
        for name, metrics in s["metrics"].items():
            if name.startswith("ret"):
                bad = {k: v for k, v in metrics.items()
                       if not 0.0 <= v <= 1.0}
                if bad:
                    raise AssertionError(f"{name}: outside [0, 1]: {bad}")
    ret = "ret%tva--synthetic"
    gaps = {k: abs(logs[ret][k] - last_eval[ret][k]) for k in last_eval[ret]}
    if logs[ret].keys() != last_eval[ret].keys() or max(gaps.values()) > 1e-6:
        raise AssertionError(f"testing run {logs[ret]} vs the step-"
                             f"{RUN_STEPS} evaluation {last_eval[ret]}")
    vocab = MiCoConfig().bert_config.vocab_size
    for toks in probe.tokens:
        if int(toks.min()) < 0 or int(toks.max()) >= vocab:
            raise AssertionError(f"caption tokens outside [0, {vocab})")
    if probe.plain_on_card:
        raise AssertionError(f"plain twins ran on the card: "
                             f"{probe.plain_on_card}")
    if not probe.resamples:
        raise AssertionError("the corrupt clip was never resampled")

    # the loader-fed step: a cycle is the wait for the batch, then
    # tokenising, the copies and the step up to its losses on the host
    # (the record's); the steady steps of the full-width run are those
    # after the first, not profiled and before the first evaluation
    prof = next(s for s in first if "busy_ms" in s)
    if prof["busy_ms"] is None:
        raise AssertionError("torch.profiler recorded no kernel of the "
                             "profiled train step")
    first_eval = min(s["step"] for s in first if s["kind"] == "eval")
    steady = [r for r in rec["steps"]
              if 1 < r["step"] <= first_eval and r["step"] != prof["step"]]
    cycle_ms = statistics.median(1e3 * (r["data_wait_s"] + r["step_s"])
                                 for r in steady)
    idle = 1.0 - prof["busy_ms"] / cycle_ms

    def io(stages, kinds):
        return [{k: s[k] for k in ("kind", "seconds", "rss_start",
                                   "rss_peak")}
                for s in stages if s["kind"] in kinds]
    result = dict(
        train_s=train_s, test_s=test_s, resume_s=resume_s,
        resume_layers=RUN_RESUME_LAYERS,
        samples_per_s=1e3 * RUN_B / cycle_ms, cycle_ms=cycle_ms,
        steady_steps=[r["step"] for r in steady],
        data_wait_s=[r["data_wait_s"] for r in rec["steps"]],
        step_s=[r["step_s"] for r in rec["steps"]],
        resamples=probe.resamples,
        profiled_step=dict(step=prof["step"], busy_ms=prof["busy_ms"],
                           wall_ms=prof["profiled_ms"]),
        idle_share=idle, synthetic_step_ms=train_step["step_ms"],
        train_peak_memory_bytes=rec.get("peak_memory_bytes"),
        synthetic_busy_ms=train_step.get("busy_ms"),
        synthetic_idle_share=train_step.get("idle_share"),
        eval_s={s["step"]: s["seconds"] for s in first if s["kind"] == "eval"},
        test_eval_s=[s["seconds"] for s in third if s["kind"] == "eval"],
        saves=io(first, ("save", "save_best")),
        loads=io(third, ("load_from_pretrained_dir", "mico_from_jax")),
        resume_cut=dict(saves=io(cut_first + second, ("save", "save_best")),
                        loads=io(second, ("resume_latest",
                                          "load_latest_opt_state"))),
        cut_losses=[s["losses"] for s in rec_c["steps"]],
        cut_step_s=[s["step_s"] for s in rec_c["steps"]],
        cut_peak_memory_bytes=rec_c.get("peak_memory_bytes"),
        losses=[s["losses"] for s in all_steps],
        metrics_last_eval=last_eval, metrics_testing=logs,
        launches={"train step": [s for s in first
                                 if s["kind"] == "train step"][0]["launches"],
                  "eval": {s["step"]: dict(s["launches"],
                                           vit_passes=s["vit_passes"],
                                           rerank_passes=s["rerank_passes"])
                           for s in first if s["kind"] == "eval"}},
        plain_on_card=probe.plain_on_card)
    log(f"  run path: {cycle_ms:.1f} ms a loader-fed step (data wait + "
        f"step, median of steps {result['steady_steps']}), "
        f"{result['samples_per_s']:.2f} samples/s; step {prof['step']} under "
        f"the profiler: busy {prof['busy_ms']:.1f} ms, idle share "
        f"{idle:.3f}; phase train's synthetic step {train_step['step_ms']:.1f}"
        f" ms, busy (ms) {ms_text(train_step.get('busy_ms'), 1)}, idle share "
        f"{ms_text(train_step.get('idle_share'), 3)} [{card}]")
    return result


# ---------------------------------------------------------------------------
# phase 9b: SCST caption fine-tuning (the differentiated K1, K5, K8 routes)
# ---------------------------------------------------------------------------

SCST_ITEMS = 64             # clips of the SCST corpus, 2-3 captions each
SCST_B = 64                 # the captioner deployment shape (PERF.md §2)
SCST_FRAMES = 8             # 8 x 257 = 2056 condition tokens a sample
SCST_STEPS = 3              # the last one under torch.profiler
SCST_FT_B = 4               # the finetune_encoder step's samples
SCST_GRAD_B = 2
SCST_RECOMPUTE_B = 4
SCST_ADV = (1.0, -0.5)      # the gradient check's injected advantages
REMAT_B = 8                 # ViT-g frames of the remat comparison
REMAT_RUNS = (("none", False, None), ("full", True, None),
              ("save:attn_out", True, "save:attn_out"),
              ("dots_with_no_batch_dims_saveable", True,
               "dots_with_no_batch_dims_saveable"))


def rel_mean_check(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """mean |d| <= REL_MEAN_ERR_MAX * mean |want| (gradients summed over
    thousands of rows are far beyond the absolute gates)."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs().mean().item()
    err = dict(max_abs_err=diff.max().item(), mean_abs_err=diff.mean().item(),
               mean_abs_ref=ref)
    log(f"  {name}: max|d| {err['max_abs_err']:.3e}  mean|d| "
        f"{err['mean_abs_err']:.3e}  (mean |ref| {ref:.3e})")
    if not err["mean_abs_err"] <= REL_MEAN_ERR_MAX * ref:
        raise AssertionError(f"{name}: mean |d| {err['mean_abs_err']:.3e} > "
                             f"{REL_MEAN_ERR_MAX} * mean |ref| {ref:.3e}")
    return err


def phase_scst_routes(fa, paths: dict) -> dict:
    """K1's, K5's and K8's differentiated routes at full width in bf16 on
    unit-std x (weights at the init std 0.02): the output and every input's
    gradient against the card's fp32 plain autograd of the same
    composition, each call's launches held (forward, then backward)."""
    gen = torch.Generator().manual_seed(11)
    out = {}
    cases = (
        ("K1", 16, 88, ("x", "g", "b0", "w", "bias"),
         lambda a, nh, s: fa.fused_ln_qkv_self_attention(
             *a, nh, s, 1e-6, True),
         lambda a, nh, s: fa.fused_ln_qkv_plain(*a, nh, s, 1e-6, True),
         dict(K3=1), dict(K4=1)),
        ("K5", 16, 112, ("x", "w", "bias"),
         lambda a, nh, s: fa.fused_qkv_self_attention(*a, nh, s),
         lambda a, nh, s: fa.fused_qkv_plain(*a, nh, s),
         dict(K3=1), dict(K4=1)),
        ("K8", 16, 112, ("x", "w", "bias", "wp", "bp"),
         lambda a, nh, s: fa.fused_qkv_attn_proj(*a, nh, s),
         lambda a, nh, s: fa.fused_qkv_attn_proj_plain(*a, nh, s),
         dict(K8=1), dict(K3=1, K4=1)))
    for name, nh, d, names, call, plain, want_fwd, want_bwd in cases:
        a = fused_qkv_inputs(gen, 8, 257, nh, d)
        w = nh * d
        a["g"] = (1.0 + 0.1 * torch.randn(w, generator=gen)).cuda()
        a["b0"] = (0.1 * torch.randn(w, generator=gen)).cuda()
        cot = torch.randn(8, 257, w, generator=gen).to("cuda", torch.bfloat16)
        scale = d ** -0.5
        ins = [a[n].detach().requires_grad_(True) for n in names]

        def fwd_bwd(fn, args):
            o = fn(args, nh, scale)
            return o, torch.autograd.grad((o.float() * cot.float()).sum(),
                                          args)

        what = f"{name} route (autograd)"
        o = run_counted(fa, paths, f"{what} forward",
                        lambda: call(ins, nh, scale), **want_fwd)
        grads = run_counted(fa, paths, f"{what} backward",
                            lambda: torch.autograd.grad(
                                (o.float() * cot.float()).sum(), ins),
                            **want_bwd)
        ref_ins = [a[n].detach().float().requires_grad_(True) for n in names]
        ro, rgrads = fwd_bwd(plain, ref_ins)
        errs = {"out": rel_mean_check(f"{what} out, {tuple(o.shape)}", o, ro)}
        for n, g, rg in zip(names, grads, rgrads):
            errs[n] = rel_mean_check(f"{what} d{n}", g, rg)
        plain_ins = [a[n].detach().requires_grad_(True) for n in names]
        ms = cuda_time_ms(lambda: fwd_bwd(call, ins), iters=5, warmup=1)
        plain_ms = cuda_time_ms(lambda: fwd_bwd(plain, plain_ins), iters=5,
                                warmup=1)
        log(f"  {what} at x {tuple(a['x'].shape)} {nh}x{d}: forward + "
            f"backward {ms:.3f} ms (bf16 plain autograd {plain_ms:.3f} ms)")
        out[name] = dict(errors=errs, ms=ms, plain_ms=plain_ms,
                         shape=list(a["x"].shape), heads=nh, head_dim=d)
        del a, ins, ref_ins, plain_ins, o, ro, grads, rgrads
    free_cuda()
    return out


def own_greedy_refs(model, tokenizer, batch, refs) -> list:
    """Each sample's references (none when `refs` is None) and the model's
    own greedy caption of it: with random weights the corpus's references
    share no n-gram with the model's captions, and every advantage would
    be 0."""
    from mico_tpu_torch.generation import cached_generate
    from mico_tpu_torch.train.objectives import compute_features

    with torch.no_grad():
        cond = compute_features(model, model.cfg, batch,
                                "v")["condition_feats_v"]
        own = tokenizer.batch_decode(cached_generate(
            model.bert, cond, max_new_tokens=40,
            compute_dtype=model.compute_dtype).cpu().numpy())
    if refs is None:
        return own
    return [(r if isinstance(r, list) else [r]) + [o]
            for r, o in zip(refs, own)]


def scst_argv(corpus: dict, out: str) -> list:
    """`python -m mico_tpu_torch.run` on configs/pretrain-omni.json (MiCo-g)
    for an `scst%tv` task over the SCST corpus: B 64 clips of 8 frames,
    40-token captions, no validation set."""
    train = [{"type": "annoindexed", "txt": corpus["txt"],
              "vision": corpus["vision"], "vision_format": "video_frame",
              "vision_sample_num": SCST_FRAMES, "n_workers": 6,
              "batch_size": SCST_B, "training": True, "name": "synthetic",
              "task": "scst%tv"}]
    return ["--config", "configs/pretrain-omni.json", "--output_dir", out,
            "--device", "cuda", "--data_cfg.train", json.dumps(train),
            "run_cfg.seed=0", "run_cfg.first_eval=false",
            "run_cfg.log_every=1", f"run_cfg.num_train_steps={SCST_STEPS}",
            f"run_cfg.valid_freq=1", "model_cfg.max_caption_len=40",
            "run_cfg.scst_finetune_encoder=false"]


def scst_run(fa, card: str, paths: dict) -> tuple:
    """SCST through `run.main` (`pipeline.train`, decoder-only): each step
    counted from 0 (K1 = blocks, the rollout's ViT pass; nothing else), a
    gradient in BERT and none in the vision tower, the seconds of each
    stage, the last step under torch.profiler (the device alone). Each
    sample's references also hold the model's own greedy caption, decoded
    before the step (`own_greedy_refs`). Saves are left out (phase run
    times them). → (result, the trained model and optimizer)."""
    import os
    import shutil
    import tempfile

    import mico_tpu_torch.pipeline as pipeline
    import mico_tpu_torch.run as run_mod
    import mico_tpu_torch.train.checkpoints as ckpt
    from mico_tpu_torch.config import MiCoConfig

    layers = MiCoConfig().eva_config.layers
    root = tempfile.mkdtemp(prefix="mico_scst_")
    seen, steps, saves = {}, [], []
    p = Patches()
    try:
        t0 = time.perf_counter()
        corpus = write_run_corpus(root, seed=1, items=SCST_ITEMS, refs=True)
        log(f"phase scst: wrote {SCST_ITEMS} clips + 1 corrupt with 2-3 "
            f"captions each in {time.perf_counter() - t0:.1f} s")
        make = pipeline.make_scst_step

        def make_scst_step(cfg, optimizer, task, tokenizer, **kw):
            step = make(cfg, optimizer, task, tokenizer, **kw)

            def counted(model, batch, generator, refs):
                seen.update(model=model, optimizer=optimizer,
                            tokenizer=tokenizer)
                timings, i = {}, len(steps) + 1
                refs = own_greedy_refs(model, tokenizer, batch, refs)

                def call():
                    return step(model, batch, generator, refs,
                                timings=timings)
                what = f"scst step {i}"
                busy = wall = None
                if i == SCST_STEPS:
                    out, busy, wall = run_counted(
                        fa, paths, what, lambda: profiled(call, cpu=False),
                        K1=layers)
                else:
                    out = run_counted(fa, paths, what, call, K1=layers)

                def grad_norm(module):
                    return torch.sqrt(sum(
                        q.grad.float().square().sum()
                        for q in module.parameters()
                        if q.grad is not None)).item()
                steps.append(dict(step=i, stages_s=timings, busy_ms=busy,
                                  profiled_ms=wall,
                                  bert_grad_norm=grad_norm(model.bert),
                                  vision_grad_norm=grad_norm(
                                      model.vision_encoder),
                                  launches=paths[what]))
                return out
            return counted
        p.set(pipeline, "make_scst_step", make_scst_step)
        p.set(ckpt.ModelSaver, "save",
              lambda self, step, model, optimizer=None: saves.append(step))
        train = run_mod.train

        def spy_train(cfg, model, *a, **kw):
            seen["bert_before"] = {n: q.detach().clone()
                                   for n, q in model.bert.named_parameters()}
            return train(cfg, model, *a, **kw)
        p.set(run_mod, "train", spy_train)
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec = run_mod.main(scst_argv(corpus, os.path.join(root, "out")))
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        p.close()
        shutil.rmtree(root, ignore_errors=True)
    model = seen["model"]
    losses = [s["losses"] for s in rec["steps"]]
    for s in losses:
        if not all(np.isfinite(v) for v in s.values()):
            raise AssertionError(f"scst: non-finite losses {s}")
    moved = max((q.detach() - seen["bert_before"][n]).abs().max().item()
                for n, q in model.bert.named_parameters())
    del seen["bert_before"]
    if not moved > 0:
        raise AssertionError("scst: the BERT parameters did not move")
    if len(steps) != SCST_STEPS:
        raise AssertionError(f"scst: {len(steps)} steps ran")
    for s in steps:
        if s["vision_grad_norm"] != 0.0 or not s["bert_grad_norm"] > 0:
            raise AssertionError(
                f"scst step {s['step']} (decoder-only): gradient norm of "
                f"BERT {s['bert_grad_norm']}, of the vision tower "
                f"{s['vision_grad_norm']}")
    # the step's own seconds (its stages), and the loop's cycle, as phase
    # run takes it: the wait for the batch and the loop's step (the
    # references' greedy decode and the step), at step 2, neither the
    # first nor the profiled; samples/s and the idle share are the cycle's
    step_s = [sum(s["stages_s"].values()) for s in steps]
    steady = rec["steps"][1]
    cycle_s = steady["data_wait_s"] + steady["step_s"]
    last = steps[-1]
    idle = (None if last["busy_ms"] is None
            else 1.0 - last["busy_ms"] / (1e3 * cycle_s))
    stage_names = ("rollout_encoder", "sample_decode", "greedy_decode",
                   "reward", "update", "optimizer")
    result = dict(
        batch=SCST_B, frames=SCST_FRAMES, condition_tokens=SCST_FRAMES * 257,
        max_caption_len=40, run_s=run_s, step_s=step_s,
        loop_step_s=[r["step_s"] for r in rec["steps"]],
        data_wait_s=[r["data_wait_s"] for r in rec["steps"]],
        grad_norms=[{k: s[k] for k in ("bert_grad_norm", "vision_grad_norm")}
                    for s in steps],
        samples_per_s=SCST_B / cycle_s, cycle_s=cycle_s,
        step_only_samples_per_s=SCST_B / step_s[1],
        stages_s=[{k: s["stages_s"].get(k) for k in stage_names}
                  for s in steps],
        losses=losses, bert_max_move=moved, peak_memory_bytes=peak,
        profiled_step=dict(busy_ms=last["busy_ms"],
                           wall_ms=last["profiled_ms"]),
        idle_share=idle, saves_left_out=saves)
    log(f"  scst%tv through run.main: {run_s:.1f} s (model, data, "
        f"{SCST_STEPS} steps); step s {[round(x, 3) for x in step_s]}; "
        f"{result['samples_per_s']:.2f} samples/s over step 2's cycle of "
        f"{cycle_s:.3f} s (data wait {steady['data_wait_s']:.3f} s; "
        f"{result['step_only_samples_per_s']:.2f} over the step alone); "
        f"peak memory "
        f"{peak / 2 ** 30:.2f} GiB [{card}]")
    for s in steps:
        log(f"  scst step {s['step']}: " + ", ".join(
            f"{k} {s['stages_s'].get(k, float('nan')):.3f} s"
            for k in stage_names) + f"; rewards sample "
            f"{losses[s['step'] - 1]['reward_sample']:.4f} greedy "
            f"{losses[s['step'] - 1]['reward_greedy']:.4f}, loss "
            f"{losses[s['step'] - 1]['loss_scst']:.4f}")
    log(f"  step {SCST_STEPS} under torch.profiler (device only): busy "
        f"{ms_text(last['busy_ms'], 1)} ms, idle share "
        f"{ms_text(idle, 3)} of step 2's cycle, {1e3 * cycle_s:.1f} ms "
        f"(wall {last['profiled_ms']:.1f} ms profiled); gradient norms "
        f"{result['grad_norms']} [{card}]")
    return result, seen


def scst_finetune(fa, seen: dict, paths: dict) -> dict:
    """One `finetune_encoder=True` step at B 4 x 8 frames on the trained
    model (references: its own greedy captions, `own_greedy_refs`): K1 =
    blocks in the rollout, K3 = K4 = blocks in the update, and the vision
    tower gets a gradient."""
    from mico_tpu_torch.train.scst import make_scst_step

    model, opt, tok = seen["model"], seen["optimizer"], seen["tokenizer"]
    layers = model.cfg.eva_config.layers
    gen = torch.Generator().manual_seed(5)
    batch = {"vision_pixels": torch.randn(
        SCST_FT_B, SCST_FRAMES, 3, 224, 224, generator=gen).cuda()}
    refs = own_greedy_refs(model, tok, batch, None)
    step = make_scst_step(model.cfg, opt, "scst%tv", tok,
                          finetune_encoder=True)
    timings = {}
    t0 = time.perf_counter()
    out = run_counted(fa, paths, "scst finetune_encoder step",
                      lambda: step(model, batch, torch.Generator().manual_seed(
                          6), refs, timings=timings),
                      K1=layers, K3=layers, K4=layers)
    seconds = time.perf_counter() - t0
    vals = {k: v.item() for k, v in out.items()}
    norm = torch.sqrt(sum(q.grad.float().square().sum()
                          for q in model.vision_encoder.parameters()
                          if q.grad is not None)).item()
    if not (np.isfinite(vals["loss_scst"]) and norm > 0):
        raise AssertionError(f"scst finetune step: {vals}, vision gradient "
                             f"norm {norm}")
    log(f"  scst finetune_encoder step B={SCST_FT_B}x{SCST_FRAMES}: {vals}; "
        f"vision gradient norm after the clip {norm:.4e}; {seconds:.2f} s "
        f"({ {k: round(v, 3) for k, v in timings.items()} })")
    del batch, step
    return dict(losses=vals, vision_grad_norm=norm, seconds=seconds,
                stages_s=timings)


def scst_grad_check(fa, model, paths: dict) -> dict:
    """The REINFORCE loss with the encoder under grad at B 2 x 8 frames,
    tokens (a bf16 sample) and advantages injected: the card in bf16 (K1's
    differentiated route: K3, K4) against the card in fp32 on the plain
    routes; the loss within LOSS_RTOL and the gradient cosine >=
    GRAD_COSINE_MIN for each optimizer group and the first and last block's
    qkv_w (phase train's gates)."""
    from mico_tpu_torch.generation import generate_scst
    from mico_tpu_torch.train.objectives import compute_features
    from mico_tpu_torch.train.optim import param_group_labels

    base = model.cfg
    cfg32 = dataclasses.replace(base, compute_dtype="float32",
                                use_flash_attention=False)
    gen = torch.Generator().manual_seed(7)
    batch = {"vision_pixels": torch.randn(
        SCST_GRAD_B, SCST_FRAMES, 3, 224, 224, generator=gen).cuda()}
    adv = torch.tensor(SCST_ADV, device="cuda")
    with torch.no_grad():
        cond = compute_features(model, base, batch, "v")["condition_feats_v"]
        tokens, _ = generate_scst(
            model.bert, cond, max_new_tokens=40, compute_dtype=torch.bfloat16,
            generator=torch.Generator("cuda").manual_seed(8), use_cache=True)
    del cond
    runs = {}
    try:
        for label, cfg in (("bf16", base), ("fp32", cfg32)):
            model.cfg = cfg
            model.zero_grad(set_to_none=True)
            fa.reset_launch_counts()
            cond = compute_features(model, cfg, batch,
                                    "v")["condition_feats_v"]
            _, logp = generate_scst(model.bert, cond, max_new_tokens=40,
                                    compute_dtype=model.compute_dtype,
                                    use_cache=True, tokens=tokens)
            loss = -(adv * logp.sum(-1)).mean()
            loss.backward()
            torch.cuda.synchronize()
            runs[label] = dict(
                loss=loss.item(), launches=fa.launch_counts(),
                grads={n: q.grad.detach().float().clone()
                       for n, q in model.named_parameters()
                       if q.grad is not None})
            del cond, logp, loss
            model.zero_grad(set_to_none=True)
    finally:
        model.cfg = base
    paths["scst gradient check (bf16)"] = runs["bf16"]["launches"]
    layers = base.eva_config.layers
    a, b = runs["bf16"], runs["fp32"]
    if (a["launches"]["K3"], a["launches"]["K4"], a["launches"]["K1"]) != (
            layers, layers, 0) or any(b["launches"].values()):
        raise AssertionError(f"scst gradient check launches: bf16 "
                             f"{a['launches']}, fp32 {b['launches']}")
    if not abs(a["loss"] - b["loss"]) <= LOSS_RTOL * abs(b["loss"]):
        raise AssertionError(f"scst loss bf16 {a['loss']} vs fp32 "
                             f"{b['loss']}")

    def cos(x, y):
        return torch.nn.functional.cosine_similarity(
            x.double().flatten(), y.double().flatten(), dim=0).item()

    labels = param_group_labels(model)
    groups = {}
    for n in a["grads"]:
        if b["grads"][n].abs().max() > 0:
            groups.setdefault(labels[n], []).append(n)
    group_cos = {g: cos(torch.cat([a["grads"][n].flatten() for n in ns]),
                        torch.cat([b["grads"][n].flatten() for n in ns]))
                 for g, ns in groups.items()}
    held = {n: cos(a["grads"][n], b["grads"][n]) for n in (
        "vision_encoder.blocks.0.qkv_w",
        f"vision_encoder.blocks.{layers - 1}.qkv_w")}
    log(f"  scst gradient check B={SCST_GRAD_B}: loss bf16 {a['loss']:.5f} "
        f"fp32 {b['loss']:.5f}; cosine by group {group_cos}; {held}")
    for name, c in {**group_cos, **held}.items():
        if not c >= GRAD_COSINE_MIN:
            raise AssertionError(f"scst gradient cosine {name} {c} < "
                                 f"{GRAD_COSINE_MIN}")
    del runs
    free_cuda()
    return dict(loss_bf16=a["loss"], loss_fp32=b["loss"],
                group_cosine=group_cos, qkv_w_cosine=held,
                launches_bf16=a["launches"])


def scst_recompute(fa, model, paths: dict) -> dict:
    """The recompute `generate_scst` under grad at B 4 over 2056 condition
    tokens on the cached route's tokens: K2 once per layer and step (12 x
    40), the summed logp within LOSS_RTOL of the cached route's, and the
    backward reaches the cross-attention weights."""
    from mico_tpu_torch.generation import generate_scst

    bert = model.bert
    gen = torch.Generator().manual_seed(9)
    cond = torch.randn(SCST_RECOMPUTE_B, DEPLOY_COND, 768,
                       generator=gen).to("cuda", torch.bfloat16)
    with torch.no_grad():
        tokens, lp_cached = generate_scst(
            bert, cond, max_new_tokens=40, compute_dtype=torch.bfloat16,
            generator=torch.Generator("cuda").manual_seed(10),
            use_cache=True)
    model.zero_grad(set_to_none=True)
    nl = bert.cfg.num_hidden_layers
    t0 = time.perf_counter()
    tok_r, lp = run_counted(fa, paths, "scst recompute generate_scst",
                            lambda: generate_scst(
                                bert, cond, max_new_tokens=40,
                                compute_dtype=torch.bfloat16,
                                use_cache=False, tokens=tokens),
                            K2=nl * 40)
    lp.sum().backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want, got = lp_cached.sum().item(), lp.sum().item()
    xgrad = min(bert.layers[i].get("xk_w").grad.abs().max().item()
                for i in range(nl))
    log(f"  recompute generate_scst B={SCST_RECOMPUTE_B} x {DEPLOY_COND} "
        f"condition tokens: summed logp {got:.4f} (cached route {want:.4f}); "
        f"min over layers of max |d xk_w| {xgrad:.3e}; forward + backward "
        f"{seconds:.2f} s; launches {paths['scst recompute generate_scst']}")
    if not torch.equal(tok_r, tokens):
        raise AssertionError("recompute generate_scst changed the tokens")
    if not abs(got - want) <= LOSS_RTOL * abs(want):
        raise AssertionError(f"recompute summed logp {got} vs cached {want}")
    if not xgrad > 0:
        raise AssertionError("the recompute backward missed a cross-attention "
                             "weight")
    model.zero_grad(set_to_none=True)
    del cond, lp
    free_cuda()
    return dict(logp_sum=got, logp_sum_cached=want, seconds=seconds)


def scst_remat(fa, model, card: str, paths: dict) -> dict:
    """One ViT-g training-route step at B 8 frames (backward of a fixed
    random projection of the tokens) with no remat, a plain checkpoint,
    `save:attn_out` and `dots_with_no_batch_dims_saveable`: peak memory,
    K3/K4 launches and ms of each; gradients against the run without remat
    (cosine >= GRAD_COSINE_MIN per optimizer group, max |d|)."""
    from mico_tpu_torch.models.eva_vit import eva_vit_forward
    from mico_tpu_torch.train.optim import param_group_labels

    vit = model.vision_encoder
    gen = torch.Generator().manual_seed(12)
    px = torch.randn(REMAT_B, 3, 224, 224, generator=gen).cuda()
    cot = torch.randn(REMAT_B, 257, 1408, generator=gen).to("cuda",
                                                            torch.bfloat16)
    labels = {n[len("vision_encoder."):]: g
              for n, g in param_group_labels(model).items()
              if n.startswith("vision_encoder.")}
    out, ref = {}, None
    for label, remat, policy in REMAT_RUNS:
        model.zero_grad(set_to_none=True)
        free_cuda()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        y = eva_vit_forward(vit, px, compute_dtype=torch.bfloat16,
                            attn_impl="flash", remat=remat,
                            remat_policy=policy,
                            train_rng=torch.Generator().manual_seed(3))
        saved = torch.cuda.memory_allocated() - base_mem
        (y.float() * cot.float()).sum().backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base_mem
        launches = fa.launch_counts()
        paths[f"remat {label} ViT-g step"] = launches
        grads = {n: q.grad.float().clone() for n, q in vit.named_parameters()
                 if q.grad is not None}
        del y
        row = dict(saved_for_backward_bytes=saved,
                   peak_above_resident_bytes=peak, ms=ms,
                   K3=launches["K3"], K4=launches["K4"])
        if ref is None:
            ref = grads
        else:
            groups = {}
            for n in ref:
                groups.setdefault(labels[n], []).append(n)
            row["group_cosine"] = {
                g: torch.nn.functional.cosine_similarity(
                    torch.cat([grads[n].flatten() for n in ns]).double(),
                    torch.cat([ref[n].flatten() for n in ns]).double(),
                    dim=0).item() for g, ns in groups.items()}
            row["max_abs_diff"] = max((grads[n] - ref[n]).abs().max().item()
                                      for n in ref)
            bad = {g: c for g, c in row["group_cosine"].items()
                   if not c >= GRAD_COSINE_MIN}
            if bad or grads.keys() != ref.keys():
                raise AssertionError(f"remat {label}: cosine {bad}")
        out[label] = row
        del grads
        log(f"  remat {label}: step {ms:.1f} ms, held for the backward "
            f"{saved / 2 ** 30:.3f} GiB, peak "
            f"{peak / 2 ** 30:.2f} GiB above the resident "
            f"{base_mem / 2 ** 30:.2f} GiB, K3 {launches['K3']} K4 "
            f"{launches['K4']}" + ("" if "group_cosine" not in row else
                                   f", cosine {row['group_cosine']}, max |d| "
                                   f"{row['max_abs_diff']:.3e}") + f" [{card}]")
    model.zero_grad(set_to_none=True)
    del ref, px, cot
    free_cuda()
    return out


def phase_scst(fa, card: str) -> dict:
    """The differentiated routes, SCST through the train entry, one
    finetune_encoder step, the gradient check, the recompute
    generate_scst and the remat policies."""
    paths = {}
    t0 = time.perf_counter()
    routes = phase_scst_routes(fa, paths)
    run, seen = scst_run(fa, card, paths)
    model = seen["model"]
    result = dict(routes=routes, run=run,
                  finetune=scst_finetune(fa, seen, paths),
                  gradient_check=scst_grad_check(fa, model, paths),
                  recompute=scst_recompute(fa, model, paths),
                  remat=scst_remat(fa, model, card, paths))
    seen.clear()
    del model
    free_cuda()
    result["phase_s"] = time.perf_counter() - t0
    log(f"  phase scst: {result['phase_s']:.1f} s")
    result["paths"] = paths
    return result


# ---------------------------------------------------------------------------
# phase 11: the data half's captioners on VAST (ViT-g, BEATs, BERT)
# ---------------------------------------------------------------------------

CAP_AUDIO_CLIPS = 128       # configs/caption-generation-audio.json's B
CAP_AUDIO_S = 30            # 3 slices of 1024 x 64 fbank: 768 tokens
CAP_VIDEO_CLIPS = 64        # configs/caption-generation-vision.json's B
CAP_VIDEO_FRAMES = 12       # written per mp4; the config samples 8
CAP_RET_CLIPS = 8           # the ret%tva evaluation: one batch
CAP_GENERATE_NUMS = 3       # the configs' model_cfg.generate_nums
CAP_VAST_STEP = 1
# VAST's ViT-g cut to this many of its 40 blocks, as phases dp, tp and pp:
# at full depth writing the native directory and loading it in each of the
# three runs took half the phase
CAP_LAYERS = 10


def write_captioner_corpus(root, seed: int) -> dict:
    """Under root: CAP_AUDIO_CLIPS 16 kHz 16-bit mono WAVs of CAP_AUDIO_S
    s (a tone plus noise), CAP_VIDEO_CLIPS mp4s written by cv2 (`mp4v`,
    CAP_VIDEO_FRAMES frames of 256 x 320), the two captioners' `meta.json`
    (ids) and the ret%tva set's annotations (the first CAP_RET_CLIPS clips
    with a caption), all drawn from `seed`."""
    import os
    import wave

    import cv2

    rng = np.random.default_rng(seed)
    audios, videos = os.path.join(root, "audios"), os.path.join(root, "videos")
    os.makedirs(audios)
    os.makedirs(videos)
    t = np.arange(CAP_AUDIO_S * 16000) / 16000
    for i in range(CAP_AUDIO_CLIPS):
        wav = (0.3 * np.sin(2 * np.pi * (120 + 13 * i) * t)
               + 0.05 * rng.standard_normal(t.shape))
        with wave.open(os.path.join(audios, f"clip{i:03d}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((wav * 32767).clip(-32768, 32767).astype(np.int16)
                          .tobytes())
    y, x = np.mgrid[0:256, 0:320]
    for i in range(CAP_VIDEO_CLIPS):
        out = cv2.VideoWriter(os.path.join(videos, f"clip{i:03d}.mp4"),
                              cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (320, 256))
        if not out.isOpened():
            raise AssertionError("cv2.VideoWriter cannot write mp4v")
        for k in range(CAP_VIDEO_FRAMES):
            base = np.stack([(x + 9 * i + 7 * k) % 256, (y * 2 + 5 * i) % 256,
                             (x + y + 11 * k) % 256], -1)
            img = (base + rng.integers(-30, 31, base.shape)).clip(0, 255)
            out.write(img.astype(np.uint8))
        out.release()
    files = {}
    for name, n, caption in (("audio", CAP_AUDIO_CLIPS, False),
                             ("video", CAP_VIDEO_CLIPS, False),
                             ("ret", CAP_RET_CLIPS, True)):
        annos = [{"video_id": f"clip{i:03d}"} for i in range(n)]
        for a in annos if caption else ():
            a["caption"] = " ".join(rng.choice(RUN_WORDS, 8))
        files[name] = os.path.join(root, f"{name}_meta.json")
        with open(files[name], "w") as f:
            json.dump(annos, f)
    return dict(files, audios=audios, videos=videos)


def cap_eva_override() -> dict:
    """VAST's EVA01-CLIP-g/14 at full width with CAP_LAYERS blocks."""
    from mico_tpu_torch.config import MiCoConfig

    return dict(MiCoConfig().eva_config.__dict__, layers=CAP_LAYERS)


def write_vast_dir(root, seed: int):
    """A pretrained run's directory of configs/default_model_cfg.json (VAST:
    EVA01-CLIP-g/14 cut to CAP_LAYERS blocks, BEATs AS2M, BERT-base) at
    full width, its weights drawn from `seed`: `log/hps.json` and the
    native `ckpt/model_step_1.npz`, written from the card. → (the model on
    the card, its model_cfg dict)."""
    from mico_tpu_torch.config import mico_config_from_dict
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.train.checkpoints import ModelSaver
    from mico_tpu_torch.utils.config_io import dump_hps

    with open("configs/default_model_cfg.json") as f:
        model_cfg = dict(json.load(f), eva_override=cap_eva_override())
    model = MiCo(mico_config_from_dict(model_cfg), device="cuda", seed=seed)
    dump_hps({"model_cfg": model_cfg}, root)
    ModelSaver(root).save(CAP_VAST_STEP, model)
    return model, model_cfg


@torch.no_grad()
def captioner_cosines(model, model_cfg: dict, corpus: dict, card: str) -> dict:
    """One clip's BEATs tokens (the mapper's 3 slices) and its
    `EmbeddingPipeline.embed_audio` embedding (the pipeline's 4 slices of
    1024 x 64, B 1), the card in bf16 against the port on the CPU in fp32
    on the same weights; then BEATs forward ms at the audio captioner's
    batch (B 128 x 3 slices), median of 3 after a warm-up."""
    import os

    from mico_tpu_torch.data.mappers import AudioMapper
    from mico_tpu_torch.models import audio as audio_mod
    from mico_tpu_torch.serve import EmbeddingPipeline

    cfg = model.cfg
    spec = AudioMapper({"audio": corpus["audios"], "audio_sample_num": 3,
                        "training": False}, model_cfg).read("clip000")
    x = torch.from_numpy(spec)[None]
    card_tokens = model.forward_audio_encoder(x.cuda()).float().cpu()
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
    ref_tokens = audio_mod.beats_forward(cpu_model.audio_encoder, x[0],
                                         torch.float32)[None]
    sizes = dict(batch_size=1, io_workers=2, melbins=cfg.audio_melbins,
                 target_length=cfg.audio_target_length,
                 resize_melbin_num=cfg.audio_melbins, fold_constants=False)
    wav = [os.path.join(corpus["audios"], "clip000.wav")]
    card_pipe = EmbeddingPipeline(model, cfg, device="cuda", **sizes)
    cpu_pipe = EmbeddingPipeline(cpu_model, cpu_model.cfg, device="cpu",
                                 **sizes)
    emb = {"card": card_pipe.embed_audio(wav), "cpu": cpu_pipe.embed_audio(wav)}
    card_pipe.close()
    cpu_pipe.close()
    del cpu_model, cpu_pipe
    out = dict(
        tokens_shape=list(card_tokens.shape),
        beats_tokens_cosine=cosine(card_tokens, ref_tokens),
        beats_tokens_min_row_cosine=min_row_cosine(
            card_tokens.reshape(-1, card_tokens.shape[-1]),
            ref_tokens.reshape(-1, ref_tokens.shape[-1])),
        embed_audio_cosine=cosine(torch.from_numpy(emb["card"]),
                                  torch.from_numpy(emb["cpu"])))
    log(f"  BEATs tokens {out['tokens_shape']}, card bf16 vs CPU fp32: "
        f"cosine {out['beats_tokens_cosine']:.6f} (least row "
        f"{out['beats_tokens_min_row_cosine']:.6f}); embed_audio cosine "
        f"{out['embed_audio_cosine']:.6f} [{card}]")
    for key in ("beats_tokens_cosine", "embed_audio_cosine"):
        if not out[key] >= COSINE_MIN:
            raise AssertionError(f"captioner {key} {out[key]:.6f} < "
                                 f"{COSINE_MIN}")
    batch = x.expand(CAP_AUDIO_CLIPS, -1, -1, -1).cuda()
    times = timed_runs(lambda: model.forward_audio_encoder(batch), 3)
    out["beats_forward_ms"] = statistics.median(times)
    out["beats_forward_times_ms"] = times
    log(f"  BEATs forward at B {CAP_AUDIO_CLIPS} x 3 slices (x "
        f"{tuple(batch.shape[2:])}): {out['beats_forward_ms']:.2f} ms, median "
        f"of {times} [{card}]")
    kern = device_time_ms(lambda: model.forward_audio_encoder(batch),
                          iters=3, warmup=1, by_kernel=True)
    if kern is not None:
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        out["beats_device_ms"] = sum(kern.values())
        out["beats_top_kernels_ms"] = {n[:80]: ms for n, ms in top}
        log(f"  BEATs device {out['beats_device_ms']:.2f} ms a call [{card}]; "
            f"the largest kernels (ms): " + "; ".join(
                f"{n[:60]} {ms:.2f}" for n, ms in top))
    return out


def captioner_argv(config: str, vast: str, out: str, val: list) -> list:
    """`python -m mico_tpu_torch.run`'s arguments for a captioner config:
    the pretrained directory, the corpus's val set and three captions a
    clip (`evaluation_mm` reads `run_cfg.generate_nums`, as JAX's does;
    the configs set `model_cfg.generate_nums`)."""
    return ["--config", f"configs/{config}", "--pretrain_dir", vast,
            "--output_dir", out, "--device", "cuda",
            "--data_cfg.val", json.dumps(val),
            f"run_cfg.generate_nums={CAP_GENERATE_NUMS}",
            f"model_cfg.eva_override={json.dumps(cap_eva_override())}"]


def captioner_val(config: str, **paths) -> list:
    with open(f"configs/{config}") as f:
        item = json.load(f)["data_cfg"]["val"][0]
    item.update(paths)
    return [item]


def captioner_run(probe, spent: dict, run_main, name: str, argv: list,
                  out: str, clips: int, card: str) -> dict:
    """One run of the entry in testing mode, its stages held by the probe,
    the seconds of its tower and decode calls (`spent`); for a captioner
    its annotation JSON and tokens checked."""
    import os

    from mico_tpu_torch.config import MiCoConfig

    probe.stages.clear()
    probe.tokens.clear()
    spent.clear()
    t0 = time.perf_counter()
    logs = run_main(argv)
    wall = time.perf_counter() - t0
    stages = list(probe.stages)
    log(f"  {name}: {wall:.1f} s through the run entry [{card}]")
    stage_lines([dict(s, step=0) if s["kind"] == "eval" else s
                 for s in stages], {"steps": []})
    (ev,) = [s for s in stages if s["kind"] == "eval"]
    parts = {k: sum(v) for k, v in spent.items()}
    log(f"  {name}: evaluation {ev['seconds']:.3f} s = " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items())
        + f", the rest (loader wait, host) "
        f"{ev['seconds'] - sum(parts.values()):.3f} [{card}]")
    result = dict(wall_s=wall, eval_s=ev["seconds"], eval_parts_s=parts,
                  logs=logs,
                  launches=dict(ev["launches"], vit_passes=ev["vit_passes"],
                                rerank_passes=ev["rerank_passes"]),
                  loads={s["kind"]: s["seconds"] for s in stages
                         if s["kind"] != "eval"})
    vocab = MiCoConfig().bert_config.vocab_size
    for toks in probe.tokens:
        if int(toks.min()) < 0 or int(toks.max()) >= vocab:
            raise AssertionError(f"{name}: caption tokens outside "
                                 f"[0, {vocab})")
    if name.startswith("cap"):
        task = name.split()[0]
        (key,) = logs
        path = os.path.join(out, f"annotations_step0_{key}.json")
        with open(path) as f:
            ann = json.load(f)
        sub = task.split("%")[1]
        if (len(ann) != clips or logs[key]["num_annotated"] != clips
                or any(len(a[f"{sub}_captions"]) != CAP_GENERATE_NUMS
                       for a in ann)):
            raise AssertionError(f"{name}: {len(ann)} annotations in {path}")
        n_tok = sum(int(t.shape[0]) for t in probe.tokens)
        if n_tok != clips * CAP_GENERATE_NUMS:
            raise AssertionError(f"{name}: {n_tok} sampled rows")
        result.update(captions=clips * CAP_GENERATE_NUMS,
                      captions_per_s=clips * CAP_GENERATE_NUMS / ev["seconds"],
                      first=ann[0])
        log(f"  {name}: {clips} clips x {CAP_GENERATE_NUMS} captions in "
            f"{ev['seconds']:.2f} s of evaluation: "
            f"{result['captions_per_s']:.2f} captions/s [{card}]; "
            f"{ann[0]['clip_id']}: {ann[0][f'{sub}_captions']}")
    else:
        bad = {k: v for m in logs.values() for k, v in m.items()
               if not 0.0 <= v <= 1.0}
        if bad:
            raise AssertionError(f"{name}: outside [0, 1]: {bad}")
    if probe.plain_on_card:
        raise AssertionError(f"plain twins ran on the card: "
                             f"{probe.plain_on_card}")
    return result


def phase_captioner(fa, card: str) -> dict:
    """The data half's captioners (configs/caption-generation-audio.json,
    -vision.json) and a ret%tva ITM re-rank through `python -m
    mico_tpu_torch.run`, from a native pretrained directory of the default
    VAST model at full width (its ViT at CAP_LAYERS blocks), over a corpus
    written to a temporary directory."""
    import os
    import shutil
    import tempfile

    import mico_tpu_torch.evaluation as ev
    import mico_tpu_torch.models.mico as mico_mod
    from mico_tpu_torch.data.mappers import VisionMapper
    from mico_tpu_torch.run import main as run_main

    layers = CAP_LAYERS
    root = tempfile.mkdtemp(prefix="mico_captioner_")
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        corpus = write_captioner_corpus(root, seed=0)
        corpus_s = time.perf_counter() - t0
        vast = os.path.join(root, "vast")
        t0 = time.perf_counter()
        model, model_cfg = write_vast_dir(vast, seed=0)
        vast_s = time.perf_counter() - t0
        log(f"phase captioner: corpus ({CAP_AUDIO_CLIPS} WAVs of "
            f"{CAP_AUDIO_S} s, {CAP_VIDEO_CLIPS} mp4s of {CAP_VIDEO_FRAMES} "
            f"frames) {corpus_s:.1f} s; VAST directory (init on the card "
            f"and the npz) {vast_s:.1f} s [{card}]")
        result = dict(corpus_s=corpus_s, vast_dir_s=vast_s,
                      **captioner_cosines(model, model_cfg, corpus, card))
        del model
        free_cuda()

        probe = RunProbe(fa, layers)
        # seconds of the towers and the decode inside each evaluation, each
        # call ending in a synchronize; the rest of an evaluation is the
        # loader's wait and the host's work
        spent = {}

        def timed(module, name, key):
            fn = getattr(module, name)

            def call(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spent.setdefault(key, []).append(time.perf_counter() - t)
                return out
            probe.p.set(module, name, call)
        timed(mico_mod, "forward_audio_encoder", "audio_tower_s")
        timed(mico_mod, "forward_vision_encoder", "vision_tower_s")
        timed(ev, "generate", "decode_s")
        runs = {}
        try:
            audio_val = captioner_val(
                "caption-generation-audio.json", txt=corpus["audio"],
                audio=corpus["audios"])
            runs["audio"] = captioner_run(
                probe, spent, run_main, "cap%ta captioner", captioner_argv(
                    "caption-generation-audio.json", vast,
                    os.path.join(root, "out_a"), audio_val),
                os.path.join(root, "out_a"), CAP_AUDIO_CLIPS, card)
            free_cuda()
            vision_val = captioner_val(
                "caption-generation-vision.json", txt=corpus["video"],
                vision=corpus["videos"])
            runs["vision"] = captioner_run(
                probe, spent, run_main, "cap%tv captioner", captioner_argv(
                    "caption-generation-vision.json", vast,
                    os.path.join(root, "out_v"), vision_val),
                os.path.join(root, "out_v"), CAP_VIDEO_CLIPS, card)
            free_cuda()
            ret_val = captioner_val(
                "caption-generation-vision.json", txt=corpus["ret"],
                vision=corpus["videos"], audio=corpus["audios"],
                audio_sample_num=3, task="ret%tva",
                batch_size=CAP_RET_CLIPS)
            runs["ret"] = captioner_run(
                probe, spent, run_main, "ret%tva ITM re-rank", captioner_argv(
                    "caption-generation-vision.json", vast,
                    os.path.join(root, "out_r"), ret_val)
                + ["run_cfg.itm_rerank=true"],
                os.path.join(root, "out_r"), CAP_RET_CLIPS, card)
        finally:
            probe.close()
        free_cuda()
        # the vision captioner's host work alone: cv2 decode of the 8
        # middle frames and the resize + normalize, clip by clip
        mapper = VisionMapper(vision_val[0], model_cfg)
        t0 = time.perf_counter()
        for i in range(CAP_VIDEO_CLIPS):
            mapper.read(f"clip{i:03d}")
        decode_s = time.perf_counter() - t0
        log(f"  cv2 decode + preprocess of {CAP_VIDEO_CLIPS} clips x 8 "
            f"frames (256 x 320 -> 224), one thread: {decode_s:.2f} s "
            f"[{card}]")
        want = {"audio": dict(vit_passes=0, rerank_passes=0),
                "vision": dict(vit_passes=1, rerank_passes=0),
                "ret": dict(vit_passes=1, rerank_passes=CAP_RET_CLIPS)}
        for key, w in want.items():
            got = {k: runs[key]["launches"][k] for k in w}
            if got != w:
                raise AssertionError(f"captioner {key}: {got}, expected {w}")
        result.update(runs=runs, cv2_decode_preprocess_s=decode_s,
                      phase_s=time.perf_counter() - t_phase)
        log(f"  phase captioner: {result['phase_s']:.1f} s [{card}]")
        result["paths"] = {
            f"captioner {key} eval": {k: v for k, v in r["launches"].items()
                                      if k.startswith(("K", "P"))}
            for key, r in runs.items()}
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()


# ---------------------------------------------------------------------------
# phase 12: data parallelism across processes (torchrun over NCCL at world
# 1; two ranks on the one card over gloo)
# ---------------------------------------------------------------------------

DP_STEPS, DP_RESUME_STEPS = 3, 4
DP_VALID_FREQ = 1           # valid_steps 3 // 1 - 1 = 2: steps 2 and 3
DP_WORLD = 2
DP_B = 2                    # samples a rank; the reference takes all 4
# (b)'s ViT-g depth: full width with 10 of its 40 blocks. At full depth
# (b) took 71.8-95.0 s on an H100 (PERF.md, PR 18 runs E and F), which
# left the script 134 s under its 1200 s limit; the gates and the ZeRO-1
# split do not depend on the depth
DP_LAYERS = 10
DP_TIMEOUT_S = 600
# Adam's eps raised and no weight decay: the first update is then close to
# linear in the gradient (not its sign, which bf16 noise flips where the
# gradient is near 0) and holds no term common to both runs
DP_OPTIM = dict(learning_rate=1e-4, clip_lr=1e-4, new_lr=1e-4,
                weight_decay=0.0, eps=1e-3, num_train_steps=10,
                warmup_ratio=0.0)


def dp_torchrun(fa, run: dict, card: str) -> dict:
    """(a) `python -m torch.distributed.run --standalone --nproc_per_node 1
    -m mico_tpu_torch.run` with `run_cfg.multihost=true run_cfg.zero1=true`
    on phase run's corpus and the arguments of its resume check (MiCo-g at
    full width with RUN_RESUME_LAYERS blocks, B 8): 3 steps, evaluations
    and saves at steps 2 and 3 (`valid_freq` 1), rank 0 writing
    `log/record.json`; then a resume at world 1 without `multihost`, in
    this process, to step 4. Its step-1 losses are held to that check's
    one-process run (the same seed, corpus, depth and draws) within
    LOSS_RTOL."""
    import os
    import shutil
    import tempfile

    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.run import main as run_main

    root = tempfile.mkdtemp(prefix="mico_dp_")
    try:
        corpus = write_run_corpus(root, seed=0)
        out = os.path.join(root, "out")
        # the arguments of phase run's resume check (its depth: the run's
        # saves and loads are phase run's to time) with the retrieval val
        # set alone (the ITM re-rank on); the resume takes none
        argv = run_argv(corpus, out)
        val = [v for v in json.loads(argv[argv.index("--data_cfg.val") + 1])
               if v["task"].startswith("ret")]
        cut = dict(MiCoConfig().eva_config.__dict__, layers=RUN_RESUME_LAYERS)
        argv += ["--data_cfg.val", json.dumps(val),
                 f"model_cfg.eva_override={json.dumps(cut)}"]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "mico_tpu_torch.run", *argv,
               "run_cfg.multihost=true", "run_cfg.zero1=true",
               f"run_cfg.num_train_steps={DP_STEPS}",
               f"run_cfg.valid_freq={DP_VALID_FREQ}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=DP_TIMEOUT_S,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        torchrun_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr)
            raise AssertionError(f"torchrun exited {proc.returncode}")
        if "process 0 of 1 on cuda:0" not in proc.stderr + proc.stdout:
            raise AssertionError("torchrun's process did not join a group")
        with open(os.path.join(out, "log", "record.json")) as f:
            rec = json.load(f)
        files = sorted(os.listdir(os.path.join(out, "ckpt")))
        log(f"  (a) torchrun, world {rec['world']} over NCCL, ZeRO-1, "
            f"{RUN_RESUME_LAYERS} blocks: "
            f"{torchrun_s:.1f} s (process, model, {DP_STEPS} steps, "
            f"evaluations and saves at steps {[e['step'] for e in rec['evals']]}); "
            f"ckpt/ {files}")
        if rec["world"] != 1 or [s["step"] for s in rec["steps"]] != list(
                range(1, DP_STEPS + 1)):
            raise AssertionError(f"torchrun record: world {rec['world']}, "
                                 f"steps {[s['step'] for s in rec['steps']]}")
        for name in (f"model_step_{DP_STEPS}.npz",
                     f"optimizer_step_{DP_STEPS}.npz"):
            if name not in files:
                raise AssertionError(f"torchrun: {name} missing from {files}")
        got, want = rec["steps"][0]["losses"], run["cut_losses"][0]
        gaps = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
        log(f"  (a) step-1 losses {got}; phase run's at {RUN_RESUME_LAYERS} "
            f"blocks {want}; relative gaps "
            f"{ {k: f'{v:.2e}' for k, v in gaps.items()} }")
        bad = {k: v for k, v in gaps.items() if not v <= LOSS_RTOL}
        if bad or got.keys() != want.keys():
            raise AssertionError(f"torchrun step-1 losses vs phase run: {bad}")
        steps_ms = [1e3 * s["step_s"] for s in rec["steps"]]
        # -- resume at world 1, no process group --
        free_cuda()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        rec2 = run_main(argv + ["run_cfg.resume=true",
                                f"run_cfg.num_train_steps={DP_RESUME_STEPS}",
                                f"run_cfg.valid_freq={DP_VALID_FREQ}",
                                "--data_cfg.val", "[]"])
        resume_s = time.perf_counter() - t0
        launches = fa.launch_counts()
        layers = 2 * RUN_RESUME_LAYERS
        if launches != {**{k: 0 for k in launches}, "K3": layers,
                        "K4": layers}:
            raise AssertionError(f"resume (one step, no evaluation): "
                                 f"launches {launches}")
        if (rec2["start_step"], rec2["end_step"], rec2["world"]) != (
                DP_STEPS, DP_RESUME_STEPS, 1) or [
                s["step"] for s in rec2["steps"]] != [DP_RESUME_STEPS]:
            raise AssertionError(f"resume: steps {rec2['start_step']} -> "
                                 f"{rec2['end_step']}, world {rec2['world']}")
        for s in rec["steps"] + rec2["steps"]:
            if not all(np.isfinite(v) for v in s["losses"].values()):
                raise AssertionError(f"dp step {s['step']}: {s['losses']}")
        run_ms = [1e3 * s for s in run["cut_step_s"]]
        result = dict(
            torchrun_s=torchrun_s, resume_s=resume_s, losses=[
                s["losses"] for s in rec["steps"] + rec2["steps"]],
            step1_relative_gaps=gaps, step_ms=steps_ms,
            resumed_step_ms=1e3 * rec2["steps"][0]["step_s"],
            peak_memory_bytes=rec.get("peak_memory_bytes"),
            resume_peak_memory_bytes=rec2.get("peak_memory_bytes"),
            run_step_ms=run_ms,
            run_peak_memory_bytes=run.get("cut_peak_memory_bytes"),
            eval_s=[e["eval_s"] for e in rec["evals"]],
            save_s=[s["save_s"] for s in rec["saves"]],
            metrics=rec["evals"][-1]["metrics"], resume_launches=launches)
        gib = (lambda b: "not measured" if b is None
               else f"{b / 2 ** 30:.2f} GiB")
        log(f"  (a) steps 1-{DP_STEPS} ms {[round(x, 1) for x in steps_ms]} "
            f"(the step's host clock, its losses read), peak "
            f"{gib(result['peak_memory_bytes'])}; phase run's steps ms at "
            f"{RUN_RESUME_LAYERS} blocks "
            f"{[round(x, 1) for x in run_ms]}, peak "
            f"{gib(result['run_peak_memory_bytes'])}; resume at world 1 "
            f"(load, step {DP_RESUME_STEPS}, evaluation, save) {resume_s:.1f} "
            f"s, its step {result['resumed_step_ms']:.1f} ms [{card}]")
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_cuda()


def dp_rank(rank: int, store: str, out) -> None:
    """(b) one rank of the two on the card. Rank 0 first takes the
    one-process step on the global batch of DP_WORLD x DP_B (the
    reference); then both ranks take the ZeRO-1 data-parallel step and the
    plain one from the same weights over gloo, each on its rows with the
    global draws. → out: per run the global losses, the launches, the peak
    memory, the step and collective seconds, and on rank 0 the cosine of
    each optimizer group's update against the reference's."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=DP_WORLD, rank=rank,
                                timeout=timedelta(seconds=DP_TIMEOUT_S))
        out.put((rank, True, _dp_rank(rank)))
    except BaseException:  # noqa: BLE001 — reported by the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _dp_rank(rank: int) -> dict:
    import torch.distributed as dist

    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.ops import flash_attention as fa
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.train.masker import mask_tokens
    from mico_tpu_torch.train.objectives import Draws
    from mico_tpu_torch.train.optim import (OptimConfig, build_optimizer,
                                            param_group_labels)
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train.workload import PRETRAIN_TASK, synthetic_batch

    base = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    cfg = dataclasses.replace(
        base, eva_override=dataclasses.replace(
            base.eva_config, layers=DP_LAYERS, drop_path_rate=0.0),
        bert_override=dataclasses.replace(
            base.bert_config, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0))
    t0 = time.perf_counter()
    model = MiCo(cfg, device="cuda", seed=0)
    build_s = time.perf_counter() - t0
    names = [n for n, _ in model.named_parameters()]
    start = [p.detach().cpu() for p in model.parameters()]
    n = DP_WORLD * DP_B
    batch = synthetic_batch(n, seed=1)
    masked = mask_tokens(batch["caption_ids"], 0.6,
                         torch.Generator().manual_seed(2))
    flip = torch.arange(n, device="cuda").roll(1)
    rows = slice(rank * DP_B, (rank + 1) * DP_B)
    layers = cfg.eva_config.layers

    def draws():
        return Draws(masks=[masked], negatives=[(flip, flip)])

    def restore():
        with torch.no_grad():
            for p, s in zip(model.parameters(), start):
                p.copy_(s)

    def update():
        return [(p.detach() - s.to(p.device)).cpu()
                for p, s in zip(model.parameters(), start)]

    def take(step, batch, mesh_draws, timers):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        got = step(model, batch, torch.Generator().manual_seed(rank),
                   draws=mesh_draws)
        losses = {k: v.item() for k, v in got.items()}
        torch.cuda.synchronize()
        return dict(losses=losses, step_s=time.perf_counter() - t0,
                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    launches=fa.launch_counts(), **timers)

    result = dict(build_s=build_s)
    ref = None
    if rank == 0:
        opt = build_optimizer(model, OptimConfig(**DP_OPTIM))
        result["reference"] = take(make_train_step(cfg, opt, PRETRAIN_TASK),
                                   batch, draws(), {})
        ref = update()
        del opt
        restore()
        free_cuda()
    dist.barrier()
    mesh = create_mesh()
    labels = param_group_labels(model)
    local = {k: v[rows] for k, v in batch.items()}
    for zero1 in (True, False):
        opt = build_optimizer(model, OptimConfig(**DP_OPTIM),
                              group=mesh.group, zero1=zero1)
        timers = {"collective_s": 0.0}

        def timed(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                torch.cuda.synchronize()
                timers["collective_s"] += time.perf_counter() - t0
                return r
            return call
        opt.sync_grads = timed(opt.sync_grads)
        opt._all_gather = timed(opt._all_gather)
        step = make_train_step(cfg, opt, PRETRAIN_TASK, mesh=mesh,
                               zero1=zero1)
        r = take(step, local, draws(), timers)
        r["moment_bytes"] = sum(
            v.numel() * v.element_size()
            for s in opt.torch_optimizer.state.values()
            for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
        if ref is not None:
            dots = {}
            for name, p, s, w in zip(names, model.parameters(), start, ref):
                u = (p.detach() - s.to(p.device)).double()
                w = w.to(p.device).double()
                d = dots.setdefault(labels[name], torch.zeros(
                    3, dtype=torch.float64, device=p.device))
                d += torch.stack([(u * w).sum(), (u * u).sum(),
                                  (w * w).sum()])
            r["group_cosine"] = {
                g: dot / max(1e-300, (uu * ww) ** 0.5)
                for g, (dot, uu, ww) in ((g, d.tolist())
                                         for g, d in dots.items())}
        r["k34_expected"] = 2 * layers
        result["zero1" if zero1 else "plain"] = r
        del opt, step
        if zero1:
            restore()
        free_cuda()
        dist.barrier()
    return result


def dp_two_ranks(card: str) -> dict:
    """(b) two ranks on the one card over gloo (NCCL refuses two ranks on
    one device): the ZeRO-1 step and the plain data-parallel step of
    PRETRAIN_TASK at full width (MiCo-g with DP_LAYERS ViT blocks, bf16
    compute on fp32 master weights, every rate 0, the draws injected), B 2
    a rank, against the
    one-process step on the global batch of 4 taken first on the same
    card: each loss within LOSS_RTOL, the cosine of each optimizer group's
    parameter update >= GRAD_COSINE_MIN; each rank's step launching what
    the reference's did (K3 and K4 2 x blocks, K2 for BERT's
    cross-attention); peak memory per rank with and without
    ZeRO-1; the collective seconds (gloo through the host)."""
    import multiprocessing
    import os
    import queue
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="mico_dp2_")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=dp_rank,
                         args=(r, os.path.join(root, "rendezvous"), out))
             for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(DP_WORLD):
            rank, ok, value = out.get(timeout=DP_TIMEOUT_S)
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
                break
            results[rank] = value
    except queue.Empty:
        errors.append("a rank gave no result")
    finally:
        for p in procs:
            p.join(timeout=10 if errors else DP_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    if errors:
        raise AssertionError("\n".join(errors))
    phase_s = time.perf_counter() - t0
    ref = results[0]["reference"]
    for rank, res in results.items():
        for kind in ("zero1", "plain"):
            r = res[kind]
            for k, v in ref["losses"].items():
                if not abs(r["losses"][k] - v) <= LOSS_RTOL * abs(v):
                    raise AssertionError(f"rank {rank} {kind}: {k} "
                                         f"{r['losses'][k]} vs {v}")
            # a rank's step runs the reference's kernels: K3 and K4 for
            # the vision and audio passes, K2 for BERT's cross-attention
            # (every rate 0 keeps it off plain math)
            want = ref["launches"]
            if r["launches"] != want or (want["K3"], want["K4"]) != (
                    r["k34_expected"], r["k34_expected"]) or not want["K2"]:
                raise AssertionError(f"rank {rank} {kind}: launches "
                                     f"{r['launches']}, the reference's "
                                     f"{want}")
    for kind in ("zero1", "plain"):
        cos = results[0][kind]["group_cosine"]
        log(f"  (b) {kind}: update cosine to the one-process step by group "
            f"{ {g: round(c, 6) for g, c in cos.items()} }; losses "
            f"{results[0][kind]['losses']} (reference {ref['losses']})")
        bad = {g: c for g, c in cos.items() if not c >= GRAD_COSINE_MIN}
        if bad:
            raise AssertionError(f"{kind} update cosine {bad}")
    gib = lambda b: f"{b / 2 ** 30:.2f} GiB"     # noqa: E731
    for rank, res in results.items():
        z, p = res["zero1"], res["plain"]
        log(f"  (b) rank {rank}: peak memory ZeRO-1 {gib(z['peak_memory_bytes'])}"
            f" (moments {gib(z['moment_bytes'])}), plain "
            f"{gib(p['peak_memory_bytes'])} (moments "
            f"{gib(p['moment_bytes'])}); step {1e3 * z['step_s']:.1f} / "
            f"{1e3 * p['step_s']:.1f} ms, of which collectives (gloo "
            f"through the host, a device sync around each call) "
            f"{z['collective_s']:.3f} / {p['collective_s']:.3f} s [{card}]")
    log(f"  (b) reference step on the global batch of {DP_WORLD * DP_B}: "
        f"{1e3 * ref['step_s']:.1f} ms, peak {gib(ref['peak_memory_bytes'])}"
        f"; phase (b) {phase_s:.1f} s")
    return dict(phase_s=phase_s, reference=ref,
                ranks={r: {k: v for k, v in res.items() if k != "reference"}
                       for r, res in results.items()})


def phase_dp(fa, card: str, run: dict) -> dict:
    t0 = time.perf_counter()
    log("phase dp: data parallelism across processes")
    free_cuda()
    a = dp_torchrun(fa, run, card)
    b = dp_two_ranks(card)
    phase_s = time.perf_counter() - t0
    log(f"  phase dp: {phase_s:.1f} s")
    paths = {f"dp {kind} step (rank {rank})": res[kind]["launches"]
             for rank, res in b["ranks"].items()
             for kind in ("zero1", "plain")}
    paths["dp resume step (world 1)"] = a["resume_launches"]
    return dict(torchrun=a, two_ranks=b, phase_s=phase_s, paths=paths)


# ---------------------------------------------------------------------------
# phase 13: tensor and sequence parallelism on the model axis (two ranks on
# the one card over gloo, model 2)
# ---------------------------------------------------------------------------

TP_WORLD = 2
TP_B = 2                    # the global batch: both ranks run all of it
# (b)-(d)'s ViT-g depth, as phase dp's (b): full width, 10 of 40 blocks
TP_LAYERS = 10
TP_BIGE_LAYERS = 4          # bigE's depth in (c): full width
TP_TIMEOUT_S = 600
SP_LOSS_RTOL = 2e-3         # SP against TP: the same step, other sums


def tp_rank(rank: int, store: str, out) -> None:
    """One rank of the two on the card (`_tp_rank`)."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=TP_WORLD, rank=rank,
                                timeout=timedelta(seconds=TP_TIMEOUT_S))
        out.put((rank, True, _tp_rank(rank)))
    except BaseException:  # noqa: BLE001 — reported by the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _tp_configs():
    from mico_tpu_torch.config import MiCoConfig

    base = MiCoConfig(max_vision_sample_num=4, max_audio_sample_num=2)
    bert = dataclasses.replace(base.bert_config, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    cfg = dataclasses.replace(
        base, eva_override=dataclasses.replace(
            base.eva_config, layers=TP_LAYERS, drop_path_rate=0.0),
        bert_override=bert)
    bige = MiCoConfig(vision_encoder_type="evaclip02_bige",
                      max_vision_sample_num=4, max_audio_sample_num=2)
    bige = dataclasses.replace(bige, eva_override=dataclasses.replace(
        bige.eva_config, layers=TP_BIGE_LAYERS))
    return cfg, bige


def _tp_eval(fa, model, ev: dict, caps: tuple, layers: int, kernel: str,
             tag: str, paths: dict) -> dict:
    """The omni embeddings of one sample (1 image, 4 frames, 2 audio
    slices, its text) and ITM of the image against the captions, each path
    counted from 0: `kernel` (K1 or K5 or K8) once a block in the one ViT
    pass, K2 in each of BERT's 12 cross-attentions of ITM."""
    with torch.no_grad():
        out = run_counted(fa, paths, f"{tag} omni eval",
                          lambda: omni_step(model, **ev), **{kernel: layers})
        itm = run_counted(fa, paths, f"{tag} ITM",
                          lambda: itm_probs(model, ev["image"], *caps),
                          **{kernel: layers, "K2": 12})
    # numpy, not tensors: a rank's tensors would reach the parent through
    # file descriptors that close when the rank exits
    return dict(feats={k: v.float().cpu().numpy() for k, v in out.items()
                       if k != "sims"}, itm=itm.float().cpu().numpy())


def _tp_rank(rank: int) -> dict:
    """Rank 0 takes the one-process references first, on the whole models
    (rank 1 waits): PRETRAIN_TASK's step on the global batch of TP_B, the
    omni embeddings and ITM of MiCo-g (K1) and of bigE (K5; K8 under
    `FUSED_ATTN_PROJ`). Then both ranks build the same models sharded over
    the model axis (`MiCo(mesh=)`), run (c) the evaluations, (b) the TP
    step and (d) the same step with `shard_condition_sequence` from the
    same weights, every rate 0 and the draws injected. → the references on
    rank 0, each path's launches and results, the per-group update dot
    products (every sharded update gathered whole), the peak memory."""
    import torch.distributed as dist

    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.ops import flash_attention as fa
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.parallel.tensor_parallel import gather_leaf, splits_of
    from mico_tpu_torch.text import BertWordPieceTokenizer
    from mico_tpu_torch.train.masker import mask_tokens
    from mico_tpu_torch.train.objectives import Draws
    from mico_tpu_torch.train.optim import (OptimConfig, build_optimizer,
                                            param_group_labels)
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train.workload import PRETRAIN_TASK, synthetic_batch

    cfg, bige = _tp_configs()
    batch = synthetic_batch(TP_B, seed=1)
    masked = mask_tokens(batch["caption_ids"], 0.6,
                         torch.Generator().manual_seed(2))
    flip = torch.arange(TP_B, device="cuda").roll(1)
    ev = {k: torch.from_numpy(v[:1]).cuda()
          for k, v in omni_inputs().items()}
    enc = BertWordPieceTokenizer()(CAPTIONS, max_length=TEXT_LEN)
    caps = (torch.from_numpy(enc["input_ids"]).long().cuda(),
            torch.from_numpy(enc["attention_mask"]).long().cuda())

    def draws():
        return Draws(masks=[masked], negatives=[(flip, flip)])

    def take(step, model, tp_cfg=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        got = step(model, batch, torch.Generator().manual_seed(0),
                   draws=draws())
        losses = {k: v.item() for k, v in got.items()}
        torch.cuda.synchronize()
        return dict(losses=losses, step_s=time.perf_counter() - t0,
                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    launches=fa.launch_counts())

    result, ref_update = {}, None
    paths = {}
    mesh = create_mesh(data=1, model=TP_WORLD)
    if rank == 0:
        t0 = time.perf_counter()
        whole = MiCo(cfg, device="cuda", seed=0)
        result["build_s"] = time.perf_counter() - t0
        result["ref_eval"] = _tp_eval(fa, whole, ev, caps, TP_LAYERS, "K1",
                                      "one-process", {})
        labels = param_group_labels(whole)
        start = {n: p.detach().cpu() for n, p in whole.named_parameters()}
        opt = build_optimizer(whole, OptimConfig(**DP_OPTIM))
        result["reference"] = take(make_train_step(cfg, opt, PRETRAIN_TASK),
                                   whole)
        ref_update = {n: (p.detach().cpu() - start[n])
                      for n, p in whole.named_parameters()}
        del whole, opt, start
        free_cuda()
        big = MiCo(bige, device="cuda", seed=0)
        result["ref_bige"] = _tp_eval(fa, big, ev, caps, TP_BIGE_LAYERS,
                                      "K5", "one-process bigE", {})
        fa.FUSED_ATTN_PROJ = True
        try:
            result["ref_bige_k8"] = _tp_eval(fa, big, ev, caps,
                                             TP_BIGE_LAYERS, "K8",
                                             "one-process bigE K8", {})
        finally:
            fa.FUSED_ATTN_PROJ = False
        del big
        free_cuda()
    dist.barrier()
    t0 = time.perf_counter()
    model = MiCo(cfg, device="cuda", seed=0, mesh=mesh)
    result["tp_build_s"] = time.perf_counter() - t0
    tag = f"tp rank {rank}"
    # (c) the evaluation on the fresh weights
    result["eval"] = _tp_eval(fa, model, ev, caps, TP_LAYERS, "K1", tag,
                              paths)
    names = [n for n, _ in model.named_parameters()]
    splits = splits_of(model)
    start = [p.detach().clone() for p in model.parameters()]

    def restore():
        with torch.no_grad():
            for p, s in zip(model.parameters(), start):
                p.copy_(s)

    # (b) the TP step, then (d) the same step with sequence parallelism
    for what, step_cfg in (("tp", cfg), ("sp", dataclasses.replace(
            cfg, shard_condition_sequence=True))):
        opt = build_optimizer(model, OptimConfig(**DP_OPTIM),
                              group=mesh.group)
        step = make_train_step(step_cfg, opt, PRETRAIN_TASK, mesh=mesh)
        r = take(step, model)
        paths[f"{tag} {what} step"] = r["launches"]
        r["moment_bytes"] = sum(
            v.numel() * v.element_size()
            for s in opt.torch_optimizer.state.values()
            for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
        dots = {}
        for name, p, s in zip(names, model.parameters(), start):
            u = p.detach() - s
            if name in splits:
                u = gather_leaf(u, *splits[name], mesh.model_axis)
            if ref_update is not None:
                w = ref_update[name].to(u.device).double()
                u = u.double()
                d = dots.setdefault(labels[name], torch.zeros(
                    3, dtype=torch.float64, device=u.device))
                d += torch.stack([(u * w).sum(), (u * u).sum(),
                                  (w * w).sum()])
        if ref_update is not None:
            r["group_cosine"] = {
                g: dot / max(1e-300, (uu * ww) ** 0.5)
                for g, (dot, uu, ww) in ((g, d.tolist())
                                         for g, d in dots.items())}
        result[what] = r
        del opt, step
        restore()
        free_cuda()
    del model, start
    free_cuda()
    big = MiCo(bige, device="cuda", seed=0, mesh=mesh)
    result["bige"] = _tp_eval(fa, big, ev, caps, TP_BIGE_LAYERS, "K5",
                              f"{tag} bigE", paths)
    fa.FUSED_ATTN_PROJ = True
    try:
        result["bige_k8"] = _tp_eval(fa, big, ev, caps, TP_BIGE_LAYERS,
                                     "K8", f"{tag} bigE K8", paths)
    finally:
        fa.FUSED_ATTN_PROJ = False
    del big
    free_cuda()
    result["paths"] = paths
    return result


def _tp_hold_eval(what: str, got: dict, want: dict, part: str = "c") -> dict:
    """The TP (or PP) evaluation against the one-process one: embedding
    cosines >= COSINE_MIN, ITM within ITM_PROB_TOL."""
    cos = {name: min_row_cosine(torch.from_numpy(got["feats"][name]),
                                torch.from_numpy(want["feats"][name]))
           for name in ("image", "video", "audio", "text")}
    gap = float(np.abs(got["itm"] - want["itm"]).max())
    log(f"  ({part}) {what}: cosine to one process {cos}; ITM max |d| "
        f"{gap:.3e}")
    bad = {n: c for n, c in cos.items() if not c >= COSINE_MIN}
    if bad or not gap <= ITM_PROB_TOL:
        raise AssertionError(f"{what}: cosines {cos}, ITM gap {gap}")
    return dict(cosine=cos, itm_max_abs_diff=gap)


def phase_tp(fa, card: str) -> dict:
    """Two ranks on the one card over gloo at data 1 x model 2: (a) K1, K5
    and K8 at the ranks' shapes are phase kernels' (the kernels line's
    rank rows); (b) the TP step of PRETRAIN_TASK at full width (MiCo-g,
    TP_LAYERS ViT blocks, B 2, every rate 0, draws injected) against the
    one-process step: each loss within LOSS_RTOL, each optimizer group's
    update cosine >= GRAD_COSINE_MIN, K3 = K4 = 2 x TP_LAYERS a rank, each
    rank's peak memory below the one-process step's; (c) the omni
    embeddings and ITM of MiCo-g (K1) and of bigE at TP_BIGE_LAYERS blocks
    (K5, then K8's fp32 partial form under FUSED_ATTN_PROJ) against one
    process: cosine >= COSINE_MIN, ITM within ITM_PROB_TOL; (d) (b) with
    `shard_condition_sequence`: each loss within SP_LOSS_RTOL of (b)'s."""
    import multiprocessing
    import os
    import queue
    import shutil
    import tempfile

    t0 = time.perf_counter()
    log("phase tp: tensor and sequence parallelism, model 2 (two ranks on "
        "the card over gloo)")
    free_cuda()
    root = tempfile.mkdtemp(prefix="mico_tp_")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=tp_rank,
                         args=(r, os.path.join(root, "rendezvous"), out))
             for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.perf_counter() + TP_TIMEOUT_S
    try:
        while len(results) < TP_WORLD and not errors:
            try:
                rank, ok, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead or time.perf_counter() > deadline:
                    errors.append(f"ranks {dead} exited without a result"
                                  if dead else "a rank gave no result")
                continue
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if errors else TP_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    if errors:
        raise AssertionError("\n".join(errors))
    r0 = results[0]
    ref = r0["reference"]
    gib = lambda b: f"{b / 2 ** 30:.2f} GiB"     # noqa: E731
    k34 = 2 * TP_LAYERS
    for rank, res in results.items():
        for what in ("tp", "sp"):
            r = res[what]
            for k, v in ref["losses"].items():
                if not abs(r["losses"][k] - v) <= LOSS_RTOL * abs(v):
                    raise AssertionError(f"rank {rank} {what}: {k} "
                                         f"{r['losses'][k]} vs {v}")
            if r["launches"] != ref["launches"] or (
                    ref["launches"]["K3"], ref["launches"]["K4"]) != (k34,
                                                                      k34):
                raise AssertionError(f"rank {rank} {what}: launches "
                                     f"{r['launches']}, the one-process "
                                     f"step's {ref['launches']}")
            if not r["peak_memory_bytes"] < ref["peak_memory_bytes"]:
                raise AssertionError(
                    f"rank {rank} {what}: peak {r['peak_memory_bytes']} not "
                    f"below the one-process step's {ref['peak_memory_bytes']}")
        sp_gap = {k: abs(res["sp"]["losses"][k] - v) / abs(v)
                  for k, v in res["tp"]["losses"].items()}
        bad = {k: g for k, g in sp_gap.items() if not g <= SP_LOSS_RTOL}
        log(f"  (d) rank {rank}: SP losses {res['sp']['losses']}, relative "
            f"gaps to TP {({k: f'{g:.2e}' for k, g in sp_gap.items()})}")
        if bad:
            raise AssertionError(f"rank {rank}: SP vs TP {bad}")
        log(f"  (b) rank {rank}: TP losses {res['tp']['losses']}; launches "
            f"{ {k: v for k, v in res['tp']['launches'].items() if v} }; "
            f"peak memory TP {gib(res['tp']['peak_memory_bytes'])}, SP "
            f"{gib(res['sp']['peak_memory_bytes'])} (moments "
            f"{gib(res['tp']['moment_bytes'])}); step "
            f"{1e3 * res['tp']['step_s']:.1f} / "
            f"{1e3 * res['sp']['step_s']:.1f} ms (gloo through the host) "
            f"[{card}]")
    for what in ("tp", "sp"):
        cos = r0[what]["group_cosine"]
        log(f"  ({'b' if what == 'tp' else 'd'}) {what}: update cosine to "
            f"the one-process step by group "
            f"{ {g: round(c, 6) for g, c in cos.items()} }")
        bad = {g: c for g, c in cos.items() if not c >= GRAD_COSINE_MIN}
        if bad:
            raise AssertionError(f"{what} update cosine {bad}")
    log(f"  (b) one-process step on the global batch of {TP_B}: "
        f"{1e3 * ref['step_s']:.1f} ms, peak {gib(ref['peak_memory_bytes'])}"
        f", launches { {k: v for k, v in ref['launches'].items() if v} }")
    evals = {}
    for rank, res in results.items():
        for key, want in (("eval", "ref_eval"), ("bige", "ref_bige"),
                          ("bige_k8", "ref_bige_k8")):
            evals[f"rank {rank} {key}"] = _tp_hold_eval(
                f"rank {rank} {key}", res[key], r0[want])
    paths = {k: v for res in results.values() for k, v in
             res["paths"].items()}
    phase_s = time.perf_counter() - t0
    log(f"  phase tp: {phase_s:.1f} s (rank 0 builds: whole "
        f"{r0['build_s']:.1f} s, sharded {r0['tp_build_s']:.1f} s)")
    return dict(phase_s=phase_s, reference=ref, evals=evals, paths=paths,
                ranks={r: {k: res[k] for k in ("tp", "sp")}
                       for r, res in results.items()})


# ---------------------------------------------------------------------------
# phase 14: GPipe pipeline parallelism of the EVA tower (two ranks on the
# one card over gloo, data 1 x stages 2)
# ---------------------------------------------------------------------------

PP_WORLD = 2                # stages; data 1
PP_B = 2                    # the global batch: both stages run all of it
PP_LAYERS = 10              # ViT-g at full width, 10 of 40 blocks: 5 a stage
PP_TIMEOUT_S = 600


def pp_rank(rank: int, store: str, out) -> None:
    """One rank of the two on the card (`_pp_rank`)."""
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=PP_WORLD, rank=rank,
                                timeout=timedelta(seconds=PP_TIMEOUT_S))
        out.put((rank, True, _pp_rank(rank)))
    except BaseException:  # noqa: BLE001 — reported by the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _pp_rank(rank: int) -> dict:
    """Rank 0 takes the one-process references first, on the whole model
    (rank 1 waits): the omni embeddings and ITM (K1), and PRETRAIN_TASK's
    step on the global batch of PP_B. Then both ranks build the same model
    staged over the two stages (`MiCo(mesh=)` at `pipeline_stages=2`),
    run (b) the evaluation on the tower gathered whole (`whole_tower`) and
    (a) the pipelined step from the same weights, every rate 0 and the
    draws injected. → the references on rank 0, each path's launches and
    results, the per-group update dot products (the other stage's blocks
    broadcast), the peak memory, the step's and the hops' seconds and the
    microbatch counts."""
    import torch.distributed as dist

    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.ops import flash_attention as fa
    from mico_tpu_torch.parallel import collectives
    from mico_tpu_torch.parallel import pipeline_parallel as pp
    from mico_tpu_torch.parallel.mesh import create_mesh
    from mico_tpu_torch.text import BertWordPieceTokenizer
    from mico_tpu_torch.train.masker import mask_tokens
    from mico_tpu_torch.train.objectives import Draws
    from mico_tpu_torch.train.optim import (OptimConfig, build_optimizer,
                                            param_group_labels)
    from mico_tpu_torch.train.train_step import make_train_step
    from mico_tpu_torch.train.workload import PRETRAIN_TASK, synthetic_batch

    cfg, _ = _tp_configs()
    cfg = dataclasses.replace(cfg, eva_override=dataclasses.replace(
        cfg.eva_config, layers=PP_LAYERS))
    pcfg = dataclasses.replace(cfg, pipeline_stages=PP_WORLD)
    batch = synthetic_batch(PP_B, seed=1)
    masked = mask_tokens(batch["caption_ids"], 0.6,
                         torch.Generator().manual_seed(2))
    flip = torch.arange(PP_B, device="cuda").roll(1)
    ev = {k: torch.from_numpy(v[:1]).cuda()
          for k, v in omni_inputs().items()}
    enc = BertWordPieceTokenizer()(CAPTIONS, max_length=TEXT_LEN)
    caps = (torch.from_numpy(enc["input_ids"]).long().cuda(),
            torch.from_numpy(enc["attention_mask"]).long().cuda())
    micro = {m: pp.auto_n_micro(batch[k].shape[0] * batch[k].shape[1],
                                PP_WORLD)
             for m, k in (("vision", "vision_pixels"),
                          ("audio", "audio_spectrograms"))}

    def take(step, model, timers=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        got = step(model, batch, torch.Generator().manual_seed(0),
                   draws=Draws(masks=[masked], negatives=[(flip, flip)]))
        losses = {k: v.item() for k, v in got.items()}
        torch.cuda.synchronize()
        return dict(losses=losses, step_s=time.perf_counter() - t0,
                    peak_memory_bytes=torch.cuda.max_memory_allocated(),
                    launches=fa.launch_counts(), **(timers or {}))

    result, ref_update, labels = dict(micro=micro), None, None
    paths = {}
    mesh = create_mesh(data=1, model=PP_WORLD)
    if rank == 0:
        t0 = time.perf_counter()
        whole = MiCo(cfg, device="cuda", seed=0)
        result["build_s"] = time.perf_counter() - t0
        result["ref_eval"] = _tp_eval(fa, whole, ev, caps, PP_LAYERS, "K1",
                                      "one-process", {})
        labels = param_group_labels(whole)
        start = {n: p.detach().cpu() for n, p in whole.named_parameters()}
        opt = build_optimizer(whole, OptimConfig(**DP_OPTIM))
        result["reference"] = take(make_train_step(cfg, opt, PRETRAIN_TASK),
                                   whole)
        ref_update = {n: (p.detach().cpu() - start[n])
                      for n, p in whole.named_parameters()}
        del whole, opt, start
        free_cuda()
    dist.barrier()
    t0 = time.perf_counter()
    model = MiCo(pcfg, device="cuda", seed=0, mesh=mesh)
    result["pp_build_s"] = time.perf_counter() - t0
    tag = f"pp rank {rank}"
    # (b) the evaluation on the tower gathered whole, the fresh weights
    t0 = time.perf_counter()
    with pp.whole_tower(model):
        result["gather_s"] = time.perf_counter() - t0
        result["eval"] = _tp_eval(fa, model, ev, caps, PP_LAYERS, "K1", tag,
                                  paths)
    named = dict(model.named_parameters())
    # on the host, as the reference's: the step's peak holds no copy
    start = {n: p.detach().cpu() for n, p in named.items()}
    # (a) the pipelined step; the hops' host clock (gloo through the host,
    # a send's staging copy and the wait for the neighbour stage included)
    timers = {"hop_s": 0.0, "hops": 0}

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            if isinstance(r, torch.Tensor):
                torch.cuda.synchronize()
            timers["hop_s"] += time.perf_counter() - t0
            timers["hops"] += 1
            return r
        return call

    real = {k: getattr(collectives, k) for k in ("send", "recv",
                                                  "broadcast")}
    opt = build_optimizer(model, OptimConfig(**DP_OPTIM), group=mesh.group)
    step = make_train_step(pcfg, opt, PRETRAIN_TASK, mesh=mesh)
    for k, fn in real.items():
        setattr(collectives, k, timed(fn))
    try:
        r = take(step, model, timers)
    finally:
        for k, fn in real.items():
            setattr(collectives, k, fn)
    paths[f"{tag} step"] = r["launches"]
    r["moment_bytes"] = sum(
        v.numel() * v.element_size()
        for s in opt.torch_optimizer.state.values()
        for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
    update = {n: p.detach() - start[n].to(p.device)
              for n, p in named.items()}
    twins = pp.remote_names(model)
    dots = {}
    for name in pp.whole_entries(model, update):
        u = pp.fetch(model, name, update, twins)
        if ref_update is not None:
            w = ref_update[name].to(u.device).double()
            u = u.double()
            d = dots.setdefault(labels[name], torch.zeros(
                3, dtype=torch.float64, device=u.device))
            d += torch.stack([(u * w).sum(), (u * u).sum(), (w * w).sum()])
    if ref_update is not None:
        r["group_cosine"] = {
            g: dot / max(1e-300, (uu * ww) ** 0.5)
            for g, (dot, uu, ww) in ((g, d.tolist())
                                     for g, d in dots.items())}
    result["pp"] = r
    result["paths"] = paths
    del opt, step, model, start, update
    free_cuda()
    return result


def phase_pp(fa, card: str) -> dict:
    """Two ranks on the one card over gloo at data 1 x stages 2 (NCCL
    refuses two ranks on one device): (a) the pipelined step of
    PRETRAIN_TASK at full width (MiCo-g, PP_LAYERS ViT blocks, 5 a stage,
    B 2, every rate 0, draws injected) against the one-process step: each
    loss within LOSS_RTOL, each optimizer group's update cosine >=
    GRAD_COSINE_MIN, each rank's peak memory below the one-process
    step's, K3 = K4 = 5 x (M_vision + M_audio) a rank (a launch a block a
    microbatch), K2 as the one-process step's and nothing else; (b) the
    omni embeddings and ITM on the tower gathered whole against one
    process: cosine >= COSINE_MIN, ITM within ITM_PROB_TOL, K1 PP_LAYERS a
    ViT pass. Prints each rank's step seconds, the hops' seconds (gloo
    through the host) and the bubble."""
    import multiprocessing
    import os
    import queue
    import shutil
    import tempfile

    from mico_tpu_torch.parallel.pipeline_parallel import bubble

    t0 = time.perf_counter()
    log("phase pp: GPipe pipeline parallelism of the EVA tower, 2 stages "
        "(two ranks on the card over gloo)")
    free_cuda()
    root = tempfile.mkdtemp(prefix="mico_pp_")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=pp_rank,
                         args=(r, os.path.join(root, "rendezvous"), out))
             for r in range(PP_WORLD)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.perf_counter() + PP_TIMEOUT_S
    try:
        while len(results) < PP_WORLD and not errors:
            try:
                rank, ok, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead or time.perf_counter() > deadline:
                    errors.append(f"ranks {dead} exited without a result"
                                  if dead else "a rank gave no result")
                continue
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if errors else PP_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    if errors:
        raise AssertionError("\n".join(errors))
    r0 = results[0]
    ref = r0["reference"]
    micro = r0["micro"]
    per_stage = PP_LAYERS // PP_WORLD
    k34 = per_stage * (micro["vision"] + micro["audio"])
    gib = lambda b: f"{b / 2 ** 30:.2f} GiB"     # noqa: E731
    for rank, res in results.items():
        r = res["pp"]
        for k, v in ref["losses"].items():
            if not abs(r["losses"][k] - v) <= LOSS_RTOL * abs(v):
                raise AssertionError(f"rank {rank} pp: {k} "
                                     f"{r['losses'][k]} vs {v}")
        want = dict(ref["launches"], K3=k34, K4=k34)
        if r["launches"] != want or not want["K2"]:
            raise AssertionError(f"rank {rank} pp: launches {r['launches']}"
                                 f", expected {want} (the one-process "
                                 f"step's {ref['launches']})")
        if not r["peak_memory_bytes"] < ref["peak_memory_bytes"]:
            raise AssertionError(
                f"rank {rank} pp: peak {r['peak_memory_bytes']} not below "
                f"the one-process step's {ref['peak_memory_bytes']}")
        log(f"  (a) rank {rank}: PP losses {r['losses']}; launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }; peak memory "
            f"{gib(r['peak_memory_bytes'])} (moments "
            f"{gib(r['moment_bytes'])}); step {1e3 * r['step_s']:.1f} ms, "
            f"of which {r['hops']} hops and broadcasts {r['hop_s']:.3f} s "
            f"(gloo through the host, the wait for the other stage "
            f"included; both stages share the one card) [{card}]")
    cos = r0["pp"]["group_cosine"]
    log(f"  (a) pp: update cosine to the one-process step by group "
        f"{ {g: round(c, 6) for g, c in cos.items()} }")
    bad = {g: c for g, c in cos.items() if not c >= GRAD_COSINE_MIN}
    if bad:
        raise AssertionError(f"pp update cosine {bad}")
    log(f"  (a) one-process step on the global batch of {PP_B}: "
        f"{1e3 * ref['step_s']:.1f} ms, peak {gib(ref['peak_memory_bytes'])}"
        f", launches { {k: v for k, v in ref['launches'].items() if v} }; "
        f"microbatches {micro} (bubble "
        f"{ {m: round(bubble(PP_WORLD, n), 4) for m, n in micro.items()} })")
    evals = {f"rank {rank} eval": _tp_hold_eval(
        f"pp rank {rank} eval", res["eval"], r0["ref_eval"], "b")
        for rank, res in results.items()}
    paths = {k: v for res in results.values() for k, v in
             res["paths"].items()}
    phase_s = time.perf_counter() - t0
    log(f"  phase pp: {phase_s:.1f} s (rank 0 builds: whole "
        f"{r0['build_s']:.1f} s, staged {r0['pp_build_s']:.1f} s; the "
        f"tower gathered whole in {r0['gather_s']:.2f} s)")
    return dict(phase_s=phase_s, reference=ref, evals=evals, paths=paths,
                micro=micro, bubble={m: bubble(PP_WORLD, n)
                                     for m, n in micro.items()},
                ranks={r: res["pp"] for r, res in results.items()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one "
              "NVIDIA H100", file=sys.stderr)
        return 2
    from mico_tpu_torch.ops import _build
    from mico_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device {kind}")
    t_start = time.perf_counter()
    wall = {}                           # seconds since the previous mark

    def mark(name: str) -> None:
        now = time.perf_counter()
        wall[name] = now - t_start - sum(wall.values())
        log(f"[wall] {name}: {wall[name]:.1f} s, {now - t_start:.1f} s "
            f"since the build began")

    _build.build_all()
    build_s = time.perf_counter() - t_start
    log(f"kernels built in {build_s:.1f} s into {_build.BUILD_DIR}")
    mark("build")
    audio = phase_audio_decode(card)
    mark("audio_decode")

    rows = phase_kernels(fa)
    rows += phase_fused_qkv_kernels(fa)
    mark("kernels")
    main_out = phase_main(fa, card)
    cosines, ref = phase_cosine(main_out)
    caption = phase_caption(fa, main_out, ref, card)
    omni = {k: main_out[k] for k in ("step_ms", "step_times", "paths")}
    del main_out, ref
    free_cuda()
    mark("main, cosine, caption")
    demo = phase_demo(fa, card)
    free_cuda()
    mark("demo")
    orbax = phase_orbax(fa, card)
    mark("orbax")
    bige = phase_bige(fa, card)
    mark("bigE")
    clip = phase_clip(fa, card)
    mark("CLIP")
    eva_clip = phase_eva_clip(fa, card)
    mark("eva_clip")
    eva02 = phase_eva02(fa, card)
    mark("EVA02")
    swin = phase_swin(fa, card)
    mark("swin")
    rows += phase_train_kernels(fa)
    rows += phase_cls_kernels(fa)
    train = phase_train_steps(fa, card)
    train["gradient_check"] = phase_train_grads(fa)
    mark("train")
    rows += phase_long_kernels(fa)
    long = phase_long_train(fa, card)
    mark("long-context")
    mlp_rows, mlp = phase_mlp(fa, card)
    rows += mlp_rows
    mark("mlp")
    scst = phase_scst(fa, card)
    mark("scst")
    run = phase_run(fa, card, train)
    mark("run")
    dp = phase_dp(fa, card, run)
    mark("dp")
    tp = phase_tp(fa, card)
    mark("tp")
    pipe = phase_pp(fa, card)
    mark("pp")
    captioner = phase_captioner(fa, card)
    mark("captioner")
    total_s = time.perf_counter() - t_start
    log(f"[wall] total: {total_s:.1f} s, by phase "
        f"{ {k: round(v, 1) for k, v in wall.items()} } [{card}]")
    paths = {**omni["paths"], **caption["paths"], **demo["paths"],
             **orbax["paths"],
             **bige["paths"],
             **clip["paths"], **eva_clip["paths"], **eva02["paths"],
             **swin["paths"],
             "train step": train["launches_per_step"],
             "train gradient check (PACKED_CLS_SPLIT)":
                 train["gradient_check"]["bf16_k9"]["launches"],
             "long-context train step": long["launches_per_step"],
             "long-context no-grad forward":
                 long["paths"]["long-context no-grad forward"],
             **mlp["paths"],
             **scst["paths"],
             "run train step": run["launches"]["train step"],
             **{f"run eval (step {step})": {k: v for k, v in c.items()
                                           if k.startswith(("K", "P"))}
                for step, c in run["launches"]["eval"].items()},
             **dp["paths"], **tp["paths"], **pipe["paths"],
             **captioner["paths"]}
    for row in rows:
        key = row["name"].split()[0]
        path = KERNEL_PATH[key]
        row.update(launches=paths[path][key], launches_path=path,
                   launches_by_path={p: c[key] for p, c in paths.items()})
    print(json.dumps({"card": card, "build_s": build_s, "wall_s": wall,
                      "total_s": total_s, "audio_decode": audio,
                      "omni_step_ms": omni["step_ms"],
                      "omni_step_times_ms": omni["step_times"],
                      "samples_per_s": 1e3 * S / omni["step_ms"],
                      "launches_by_path": paths, "cosine": cosines,
                      "caption": {k: v for k, v in caption.items()
                                  if k != "paths"},
                      "demo": {k: v for k, v in demo.items()
                               if k != "paths"},
                      "orbax": {k: v for k, v in orbax.items()
                                if k != "paths"},
                      "bige": {k: v for k, v in bige.items()
                               if k != "paths"},
                      "clip": {k: v for k, v in clip.items()
                               if k != "paths"},
                      "eva_clip": {k: v for k, v in eva_clip.items()
                                   if k != "paths"},
                      "eva02": {k: v for k, v in eva02.items()
                                if k != "paths"},
                      "swin": {k: v for k, v in swin.items()
                               if k != "paths"},
                      "mlp_probe_chain_ms": mlp["chain_ms"],
                      "train": {k: v for k, v in train.items()
                                if k != "paths"},
                      "long_context": {k: v for k, v in long.items()
                                       if k != "paths"},
                      "scst": {k: v for k, v in scst.items()
                               if k != "paths"},
                      "run": run,
                      "dp": {k: v for k, v in dp.items() if k != "paths"},
                      "tp": {k: v for k, v in tp.items() if k != "paths"},
                      "pp": {k: v for k, v in pipe.items() if k != "paths"},
                      "captioner": {k: v for k, v in captioner.items()
                                    if k != "paths"}}, default=str))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
