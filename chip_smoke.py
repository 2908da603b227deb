#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Uses torch, numpy and the standard library only (no JAX, no msgpack, no
flax).  Phases, each of which fails the run (non-zero exit) on error:

1. card: prints ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels (every ``ops/csrc/*.cu``, one
   nvcc each, in parallel) from this checkout's sources, and prints each
   kernel's registers and spills (one JSON line for the flash kernels);
3. Xception kernels: K1 and K2 at the main path's shapes (batch 16 of the
   299-px clothing model) against their plain PyTorch versions (relative
   max error < 2e-2: bf16 rounding, summed in another order); times
   kernel, plain version and a library yardstick (depthwise ``conv2d`` +
   ``matmul`` + affine: cuDNN/cuBLAS, used nowhere in the port) with CUDA
   events;
   Then one ``stage`` line for every shape at which a main path launches
   the stage kernel (K1, K2 at buckets 16 and 1, the entry path's blocks 3
   and 4) and on a wide image (147x147, 64 and 128 channels: the stages K5
   launched before it kept them on chip; no path launches them now): one
   launch against its plain version, its time beside the library stage
   and the bound, and its GEMM rate;
4. Xception server: writes a ``clothing-model`` artifact with random
   weights from ``--seed`` (flax layout, the port's own msgpack writer),
   starts the port's model server with buckets (1, 4, 16), warms it and
   sends JSON ``:predict`` requests of 1, 3 and 16 images.  It checks the
   shapes, finite logits, agreement with the same server's exact float32
   graph, that the engine took the fused fast path, and that the requests
   went through the kernels (8 K1 and 2 K2 launches per forward, credited
   by the bucket graphs' replays); each bucket's CUDA graph against the
   eager forward module (``graph``: bit-equal, else within 1e-3), the
   kernels of one traced replay counted by name (``trace-launches``), the
   graph pool's device memory (``graph-memory``); then the p50 of a
   1-image request on a fresh connection against one kept alive, and
   img/s and p50 per bucket, replayed and eager.  (ViT and B3 below get
   the same lines.)  Then the quant phase: the same model's v2
   ``int8-weight-only`` and v3 ``int8-w8a8`` written by the port's
   ``ops.quantize.write_quantized_version`` (v3 calibrated on the card from
   8 noise images at percentile 100: its seconds and its 68 layers; the
   committed fixtures read as ``--calibrate-dir`` does, without PIL), and
   v4, v3 with every activation scale x1000; Q1 (``int8_conv``: a quantize
   pass and a wgmma s8 GEMM) and Q2 (``int8_depthwise``,
   ``ops/csrc/int8_conv.cu``) on the w8a8 forward's own layers at every
   shape it launches them (batches 16 and 3, and 1 for the middle flow's),
   each equal to its plain version (max abs difference 0), timed beside
   the plain version, ``torch._int_mm`` on the codes (1x1 stride-1 shapes:
   the yardstick, used nowhere in the port), the bound and the rate, and
   for Q1 its quantize pass's time and share and the GEMM instance
   (``int8-kernel`` lines); the device bytes of the w8a8,
   weight-only and bf16 float engines' parameters; v3 served over msgpack
   (requests of 1, 3, 16): serving ``int8-w8a8`` after the warmup gate
   (its drift and top-1 printed), 39 Q1 and 29 Q2 launches a forward and
   no K1/K2, replies equal to the engine's, ``kdlt_quant_scheme`` 1 for
   it on /metrics; v2 served: 8 K1 and 2 K2 a forward, logits bit-equal
   to a float engine on the host-dequantized tree; v4 served: the gate
   refuses it (``kdlt_quant_gate_failures_total`` 1, ``:status``
   int8-w8a8 / int8-weight-only, K1/K2 and no Q1/Q2); then w8a8 against
   weight-only on 16 grid images (drift <= KDLT_QUANT_TOL, top-1 >=
   0.99), each w8a8 bucket graph bit-equal to eager, one traced replay
   (39 + 39 + 29 kernels by name: Q1's two), and p50 at buckets 1, 4, 16 of the w8a8,
   weight-only and bf16 fused engines in turns (``quant``; with
   ``--profile`` each engine traced at bucket 16).  Then the batching
   phase: the host CPU time of a
   default and a ``blocking=True`` CUDA event's wait (``event-wait``);
   then four servers of the same model with buckets (1, 2, 4, 8, 16, 32)
   -- batching off, the scheduler's lane (``runtime/scheduler.py``, the
   server's default) at depth 1 and at depth 2, and the C++ queue at
   depth 2 (``--batcher native``) -- after the depth-2 engine's
   bucket graphs are held against eager (``batching-graph``), each
   driven three times, in turns, by the load generator
   (``serving/loadgen.py``, a process of its own): 32 closed-loop clients
   on kept-alive connections, 25 one-image msgpack requests each, every
   request its own image.  Per run one ``batching`` line: img/s, p50 and
   p99 of the request time, forwards, mean batch, padding rows, the mean
   ms a batch of the engine's dispatch->sync and of each dispatcher
   stage, and the K1 and K2 launches, which must be 8 and 2 per forward
   (per arm, a ``batching-arm`` line of medians).  Every reply must lie
   within 5e-2 of the exact f32 graph for its own image, and nearer to
   that image's logits alone through the same engine (bucket 1) than to
   any other image's.  One more run of each depth-2 arm, traced, gives
   the device's busy share, beside the dispatch stage's ms at buckets 16
   and 32 with no load and the copy into a staging slot alone
   (``batching-profile``);
5. Xception entry-kernel path: K5 (conv2 + block2) at 149x149x32 ->
   74x74x128, batches 1, 3 and 16, with the clothing model's weights, and
   K2 at blocks 3 and 4 of that path (74x74 128->256->256, 37x37
   256->728->728, batch 16), against their plain versions (< 2e-2); times
   kernel, plain version, a library yardstick (cuDNN ``conv2d`` for conv2
   and the depthwise, cuBLAS ``matmul`` for the 1x1s, torch elementwise
   and max-pool: used nowhere in the port) and the bound, and K5 and the
   yardstick as device time by CUDA-graph replay, with the segment length
   the launcher picked (one launch a call; b, c and d stay on chip).  Then the
   entry-kernel forward (``XceptionFast(entry_kernel=True)``): 1 K5, 8 K1
   and 4 K2 launches per forward for batches 1, 3, 16, logits within 2e-2
   of the default fused route and of the exact f32 graph, p50 and img/s of
   both routes at buckets 1, 4, 16 in turns (with ``--profile``: both
   traced, and K5's share of device time);
6. attention kernel: K3 at ViT-B/16-384's shape (16, 12, 576, 64) in bf16
   and in f32 (the exact graph's), and at small ragged, causal, fully
   masked (all 0) and other head-dim cases, against its plain version
   (relative max error < 2e-2 bf16, < 1e-4 f32); times kernel, plain
   version and ``scaled_dot_product_attention`` (the yardstick, used
   nowhere in the port), each eagerly and (kernel and yardstick) as
   device time by CUDA-graph replay, in bf16 and f32; prints the bound
   (f32 products on the tensor cores as 3xTF32), the q-tile the bf16
   kernel chose on this card and the host cost of a tensor map;
7. ViT server: a ``vit-b16-384`` artifact (ViT-B/16 at 384 px: 576 tokens,
   the flash route) served the same way over the msgpack wire.  ViT has no
   fused fast path (its kernel sits inside its attention); the requests
   must launch K3 12 times per forward, and the bf16 logits must agree
   with the exact f32 graph (relative < 5e-2); then img/s and p50;
8. routing: one predict of the registered ``vit-b16-imagenet`` (256 px,
   256 tokens) must take the einsum route: zero K3 launches;
9. folded attention: K3G (``flash_gfold``, E5's port), one call for each
   g in (1, 4, 8) at E5's shape (32, 12, 256, 64) bf16 (the launches
   counted), then each g against the plain version at that shape and at
   ViT-B/16-384's (16, 12, 576, 64) (< 2e-2), timed beside K3 and
   ``scaled_dot_product_attention`` (the yardstick), with the bound;
10. partials kernel: K3P at the training shape (32, 12, 256, 64) in f32
   (``fit``'s) and bf16, and at small ragged, causal, ``kv_len``,
   no-visible-key and other head-dim cases, against its plain version on
   the rows with a visible key (relative < 1e-4 f32, < 2e-2 bf16; the
   other rows exactly (0, NEG_INF, 0)); times kernel, plain version, the
   kernel with its finalisation to (out, lse), and the aten attention op
   that returns (out, logsumexp) (the yardstick, used nowhere in the
   port), eagerly and by CUDA-graph replay; prints the bound;
11. gradients: ``attention_trainable`` (K3P forward, blockwise torch
   backward) against autograd through plain f32 attention at the training
   shape (relative < 1e-4), and the time of its forward and backward;
12. training: ``fit()`` on ``vit-b16-imagenet`` (ViT-B/16 at full width
   and depth), f32, batch 32, Adam, 10 steps on one repeated
   ``synthetic_batches`` batch, checkpointing every 5 steps.  The loss
   must fall; the first step's loss must equal the eval-mode (einsum
   route) loss of the same weights (relative < 1e-4); the run must launch
   K3P 12 times per step and K3 never (its final eval pass included).
   Then step-ms p50 and img/s over further steps, peak device memory, and
   3 steps of ``build_train_step(dtype=torch.bfloat16)`` (bf16 K3P: 12
   launches per step);
13. checkpoint and serve: the step-10 checkpoint restored into a fresh
   state (bit-equal parameters), a resumed ``fit`` to step 12,
   ``fit_and_export`` into a temporary root (resumed at 12: no new step),
   and the artifact served by the port's engine on ``cuda``: its bf16 and
   exact f32 logits must match the trained parameters' eval forward;
14. MBConv kernel: K4 at the 7 shapes of EfficientNet-B3's 18 fused
   blocks (300 px, batch 16), taken with their own weights from a seeded
   B3, plus a batch-3 case and an EfficientNet-B0 case (56 x 56, S = 6),
   against its plain version (relative max error < 2e-2); times kernel,
   plain version, a library yardstick (cuBLAS ``matmul`` for expand and
   project, cuDNN depthwise ``conv2d``, torch elementwise ops for BN,
   silu and the squeeze-excite: used nowhere in the port) and the bound,
   each summed over the 18 calls of one bucket-16 forward; kernel and
   yardstick also as device time by CUDA-graph replay (every case), and
   each of K4's three launches alone (expand + depthwise, squeeze-excite,
   projection) on the batch-16 lines;
15. EfficientNet-B3 server: ``efficientnet-b3-imagenet`` (300 px, torch
   normalization) served the same way over the msgpack wire, on the fused
   route: 18 K4 launches per forward, logits near the exact f32 graph;
   then the same requests on a ``fast=False`` bf16 engine (the exact
   graph: no K4 launch, the fused route within 2e-2 relative of it) and
   its bucket-16 p50, so the default route can be chosen on this card;
16. ResNet50 (BASELINE config 3): ``resnet50-imagenet`` at 224 px, all 16
   bottleneck blocks, bf16, served with buckets (1, 4, 16, 32): its path
   is cuDNN convolutions and must launch none of the hand kernels; every
   bucket's graph must replay bit-equal to the eager forward, the bf16
   logits lie within 2e-2 of the exact f32 graph (TF32 off), and a
   3-image msgpack ``:predict`` return the engine's logits; then graph
   and eager p50 and img/s per bucket (``resnet-bucket``), and with
   ``--profile`` the device ms at bucket 16.  Then ``resnet50-imagenet``
   and ``efficientnet-b3-imagenet`` as int8 (``quant-family`` lines): v1
   float, v2 int8-weight-only, v3 int8-w8a8 calibrated on the card (8
   noise images at percentile 100; every quantized layer scaled: 53 and
   102), each arm's engine on graphs at buckets (1, 4, 16); the w8a8
   gate's drift and top-1 (``quant-family-gate``); v3 served over msgpack:
   53 Q1 (ResNet50) or 82 Q1 and 20 Q2 (B3) launches a forward and no
   other hand kernel, each w8a8 bucket graph bit-equal to eager, one
   traced replay with those kernels by name and no more library
   convolutions than float ones left (if the gate refuses w8a8 on the
   random weights, the run says so and checks that v3 served
   weight-only); every distinct Q1/Q2 shape of the w8a8 forward at batch
   16 against its plain version (max abs difference 0, ``int8-kernel``
   lines with the model), and p50 per arm and bucket in turns; the
   phase's seconds;
17. admission: ``clothing-model`` on the batching phase's depth-2 server
   (buckets 1-32) with admission on: a request with
   ``X-Request-Deadline-Ms: 0`` must get a JSON 504 with the engine's
   image counter unmoved; the overload A/B drives the open-loop load
   generator (4 processes, 128 kept-alive connections each) at twice the
   depth-2 arm's img/s for 8 s, 600 ms a request, against admission on
   and ``--no-admission`` (``overload`` lines: offered rate, goodput,
   in-deadline p50/p99, sheds by reason, the limit; every 200 must carry
   its own image's logits, every 503/504 a JSON body, every 503 a
   ``Retry-After`` in the limiter's range, every forward K1 8 and K2 2
   launches; JAX's criterion is printed, not gated); then a server
   process under 16 closed-loop clients gets SIGTERM (``drain``: /readyz
   503 "draining", new requests 503 "draining", nothing admitted lost,
   exit 0);
18. multimodel: ``clothing-model`` (K1, K2) and ``vit-b16-384`` (K3) on one
   server (buckets 1-32, depth 2, ``--no-admission``): ViT's img/s alone
   under closed-loop 8-image requests, then both models' batches replayed
   in turn through the shared dispatcher must equal each replayed alone
   bit for bit; then a server per ``--sched-policy`` (weighted_deadline,
   then fifo), 8 s each under two open-loop loads on one schedule (the
   JAX bench's --multimodel-ab defaults): ViT at twice its img/s in
   8-image requests with 2 s budgets, clothing-model at 40 one-image
   requests a second with 300 ms budgets.  Per model and arm (``multimodel``
   lines): offered, completed, in-deadline, goodput as a fraction, p50/p99,
   and the device's busy share; every 200 must carry its own images'
   logits within 5e-2 of the exact f32 graph, every other reply be a JSON
   503/504, every forward launch 8 K1 and 2 K2 (clothing) or 12 K3 (ViT);
   JAX's criterion is printed, not gated;
19. reload: ``clothing-model`` v1 under 16 closed-loop one-image clients,
   the version watcher every 0.5 s; v2 (weights from ``--seed`` + 1), v3
   (+ 2) and v4 (a byte copy of v3) renamed into place in turn.  No
   request may fail; each reply must carry the logits of the version its
   ``X-Kdlt-Artifact-Hash`` names, and after a swap plus one scan only the
   new version's; the hash and ``:status`` must change at v2 and v3 and
   not at v4 (same engine, no capture); /readyz must stay 200; after each
   unload ``memory_allocated`` must be within 16 MiB of one version's.
   ``reload-swap`` lines: swap and warmup seconds, allocated, peak and
   reserved memory; ``reload``: p99 inside the reload windows and steady;
20. observability: ``clothing-model`` on its own server (buckets 1-32,
   depth 2, the scheduler's lane, admission on) with the port's tracer,
   SLO engine, flight recorder and MFU gauges: 64 one-image requests with
   ``X-Request-Id``, each span tree (``/debug/trace/<rid>``) held to the
   JAX server's: nine spans, server.request over admission, decode and
   predict, the queue wait and the four pipeline stages under predict and
   contiguous, at least 95% of server.request covered by its children
   (``observability-spans``: the median ms of each span); 16 closed-loop
   clients for 6 s, after which ``/debug/slo`` must count the load
   generator's replies, ``kdlt_mfu_pct`` must lie in (0, 100] for every
   bucket ``/debug/profile?audit=buckets`` saw served and
   ``kdlt_device_busy_ratio`` in (0, 1], and the bucket-16 gauge within
   25% of 16 x FLOPs/img over the bucket graph's device ms by replay
   (``observability-mfu``); a 2 s ``/debug/profile`` (the port's CUPTI
   collector) inside a second 8 s load: ``trace.json`` parses, the
   ``kernels`` summary counts 28
   ``sepconv_stage_kernel`` launches per forward the launch counter
   credited between the profiler's start and stop (+-56), with the top 10
   device operations and the p99 of requests during the capture against
   outside it (``observability-profile``); a declared stall: two
   requests get the stall 503, exactly one incident bundle holds the first
   one's ``dispatch.stall`` event and pinned trace; and the host µs of the
   accounting after a reply (10,000 synthetic requests), beside the
   batching phase's depth-2 img/s and its 940 before the layer.  The p99
   during the capture must stay within 3x the p99 outside it (ROADMAP C5;
   ``observability-stall``: the slowest requests and the longest span
   without a reply, from the recording's start);
21. ingest-formats: every fixture of ``tests/ingest_fixtures/formats``
   (progressive JPEG of several scan scripts, Adobe CMYK, YCCK and
   marker-less 4-component JPEG, 4:4:0, 4:1:1, 16-bit PNG of colour types
   0/2/4/6, Adam7 PNG at depths 1-16 and in palette, four JPEGs of 512 px
   and more) must decode on this host, without PIL, to the shape and pixel
   SHA-256 PIL gave (``digests.json``); prints the count per format and
   the host ms per megapixel of the 800x600 photo from its progressive and
   its baseline file;
22. gateway: ``POST /predict {"url"}`` through the port's own gateway.
   The committed fixtures (``tests/ingest_fixtures``: JPEG at 4:4:4,
   4:2:2, 4:2:0 with restarts, greyscale; PNG palette and RGBA; and from
   ``formats/`` two progressive JPEGs, a CMYK JPEG and a 16-bit Adam7 PNG)
   must decode here, without PIL, to the pixels PIL gave; colour-grid PNGs written
   with zlib are served with them from a local http.server (a process of
   its own).  ``clothing-model`` (seed weights, buckets 1-32, depth 2, the
   scheduler's lane) serves on ``cuda`` in this process; two gateways run
   as processes of their own (``python -m ...serving.gateway``, the
   ``kdlt-torch-gateway`` entry point): the bytes wire (the default: the
   server decodes) and the tensor wire (``KDLT_INGEST=0``: the gateway
   decodes).  One request at a time, every fixture and four grids must get
   the 10 labels with scores bit-equal to the tensor wire's straight to the
   server for the same locally decoded pixels, on both wires, at 8 K1 and
   2 K2 launches a forward; the bytes gateway must have sent the bytes wire
   (the server decoding every image) and the tensor one none; a repeated
   URL must be a cache hit with the same body and no forward, a GIF a JSON
   400.  Then 16 traced requests a wire (``gateway-spans``: median fetch,
   decode, resize, upstream and the server's decode ms) and, for 16 and 32
   closed-loop clients (384 distinct images each), img/s, p50, p99,
   forwards and launches through each gateway and on the tensor wire
   direct (``gateway-load``);
23. device-resize: ``clothing-model`` on two servers of one artifact, the
   default (the bytes wire decodes and resizes to 299 on the host) and
   ``KDLT_INGEST_DEVICE_RESIZE=512x512`` (the host resizes to 512x512, the
   engine's staged bucket graph resizes to 299 on the card: nearest, as
   the model's filter).  The four large fixtures and 12 generated PNGs
   (640x480, 1024x768), one request an image and one of 16, on both
   servers' bytes wire: every staged reply must be the staged engine's own
   dispatch of the same pixels, every staged chunk 8 K1 and 2 K2 launches,
   each staged bucket graph its eager form (bit-equal or 1e-3); top-1
   agreement and the max abs logit difference against the default route
   are printed, not gated.  A traced bucket-16 replay of each route (28
   stage-kernel launches in both; the staged one's extra kernels are the
   resize's), and of a linear-resize variant (the resize's two float32
   GEMMs among them: ``device-resize-trace``); the resize's device ms at
   bucket 16 for each method beside its bytes bound; the p50 of each
   route's dispatch at buckets 1, 4 and 16 in turns; the host decode ms an
   image at 512x512 against at 299;
24. train-bn: the BatchNorm families' train mode, f32 with TF32 off,
   batch 32, Adam.  ``clothing-model`` at full width (299 px, its
   100-unit hidden head) fine-tuned by ``fit`` from an image folder (every
   committed JPEG and PNG fixture three times under new names, over the
   ten labels) through ``image_folder_batches``, checkpointing and
   evaluating every 5 steps and at the end (finite losses); the step-10
   checkpoint restored into a fresh state (parameters and running
   statistics bit-equal) and resumed for 2 steps; ``fit_and_export``
   served by the port's engine on graph buckets 1 and 16 (8 K1 + 2 K2 a
   forward; bf16 within 5e-2 and the f32 graph within 1e-4 of the trained
   state's exact f32 eval forward, top-1 agreement printed); one step with
   the running mean and variance of its first and last BatchNorm held
   within 1e-5 of ``0.99 * old + 0.01 * batch`` recomputed in float64
   from the layer's input, and at the last under a tenth of the
   unbiased variance's distance (flax's biased variance, told apart on the
   card); 10 steps on one repeated batch (the loss must
   fall); step p50, img/s and peak memory over 5 synced steps, device
   time by kernel over 2 (``profile`` lines), 3 bf16 steps.  Then
   ResNet50 (224 px) and EfficientNet-B3 (300 px) at full width: 5 steps
   on a repeated batch (the loss falls), the same running-statistics,
   timing and profile lines, and the export served once (ResNet50 with no
   hand kernel, within 2e-2; B3 on 18 K4 launches a forward, within
   5e-2).  One ``train-bn`` JSON line;
25. export: the reference's lifecycle at full width, each step through
   its console script's module as a process of its own (``python -m``):
   ``clothing-model`` seeded and written as a Keras-layout ``.h5``
   (``model_weights/xception/<layer>/<layer>/<w>:0``, about 84 MB) by
   ``_write_h5``, the superblock-0 subset h5py writes, with no h5py;
   imported by ``h5lite`` bit-equal to the written variables;
   ``kdlt-torch-export --weights --calibrate 8`` (v1 bf16, v2 w8a8
   calibrated on the card at percentile 100); ``kdlt-torch-inspect
   --root``; ``kdlt-torch-warm`` into an empty build directory (every
   native library built, v2's bucket graphs captured); a
   ``kdlt-torch-model-server`` booted against that directory (v1 alone
   under its root) behind a ``kdlt-torch-gateway``; ``kdlt-torch-client``
   on a committed JPEG fixture over a local http.server, its printed
   scores bit-equal to the tensor wire's for the same pixels, 8 K1 + 2 K2
   a forward (``kdlt_kernel_launches`` on the server's /metrics); v2
   linked into the root, swapped in by the watcher, the client again
   (``--cache-bust``): 39 Q1 + 29 Q2 a forward, no K1/K2; the server built
   no library (``kdlt_native_builds`` 0 and its boot line);
   ``kdlt-torch-verify-golden`` exits 1 (seeded weights are not the
   golden ones) with scores within 1e-3 of the exact f32 forward; then,
   in this process, its two engine checks both pass on the same model
   with the pants bias raised to lead by 8, against that model's exact
   f32 scores as the golden dict: the served one (bf16, ``fast="auto"``)
   within its 0.2 on 8 K1 + 2 K2 a forward.  One ``export`` JSON line
   with each step's seconds;
26. generate: the generative lane (``runtime.decode``, ``serving.generate``;
   no hand kernel: JAX's decode lane reaches no Pallas kernel) for
   ``gen-default`` at JAX's defaults (4 slots, 16-token pages, 8 pages a
   sequence) on the card.  Its warmup captures 4 CUDA graphs (prefill
   buckets 16, 32, 64 and the step at width 4); each graph against the
   eager function on the same inputs, teacher-forced over 60 steps with
   prompts in every bucket: the cache after every replay within 1e-5
   relative of eager's (the trash page aside) and the same token wherever
   eager's top-2 logit margin is above 1e-4 (the positions under it are
   counted); JAX's five mixed-bucket, mixed-budget requests on the
   continuous scheduler, then 16 staggered requests with
   ``KDLT_DECODE_SLOTS=16``, every stream bit-identical to ``decode_solo``
   through the same graphs, every page and slot back after each run; the
   port's model server with ``decode=True`` (a stub image model beside the
   lane) behind the port's gateway: the client's ``generate_stream`` equal
   to the JSON answer and to ``decode_solo``, ``/generate/nope`` a 404, the
   ``decode`` section of ``/debug/slo`` counting the generations; then,
   printed and not gated, each graph's replay time and TTFT/TPOT p50/p99
   and tokens/s of 32 requests on the continuous and the static scheduler,
   in turns.  One ``generate`` JSON line with the phase's seconds;
27. with ``--profile``: the host time by op of a few bucket-16
   ``predict_async`` dispatches of the batching phase's engine
   (``batching-host``); a ``torch.profiler`` trace of a few bucket-16
   forwards of each served model (and of B3's ``fast=False`` engine, and
   of the Xception entry-kernel and default forwards) and of a few f32 and
   bf16 training steps, printed as device time by kernel and the device's
   busy share.

Before them, a ``smoke`` line gives the script's own wall time.  The last
two lines are a JSON ``kernels`` record and the device record.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# H100 SXM dense peaks (NVIDIA data sheet) for the bound: bf16 and TF32
# tensor cores, f32 on the CUDA cores (the depthwise taps), HBM3.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# exp2 on the special-function units: 16 per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); the rate is this times the SMs times the card's max SM clock.
SFU_EXP_PER_CLOCK_SM = 16
KERNEL_TOL = 2e-2  # relative max error, bf16 kernel vs its plain version
MBCONV_PHASES = ("expand_dw", "se", "project")  # K4's three launches
F32_KERNEL_TOL = 1e-4  # the same for the f32 attention kernel
MODEL_TOL = 5e-2   # relative max error, bf16 serving path vs exact f32 graph
BUCKETS = (1, 4, 16)
REQUESTS = (1, 3, 16)
ITERS = 20  # timed repetitions per kernel and per bucket
TRAIN_BATCH = 32
TRAIN_STEPS = 10  # fit() steps; checkpoints every TRAIN_STEPS // 2
TIMED_STEPS = 5   # further f32 steps timed one by one (device-synced)
BF16_STEPS = 3
TRAIN_LR = 1e-4
_CSRC = "kubernetes_deep_learning_tpu_torch/ops/csrc/"
SOURCES = {
    "fused_sepconv_block": _CSRC + "fused_sepconv.cu",
    "fused_sepconv_chain": _CSRC + "fused_sepconv.cu",
    "flash_attention": _CSRC + "flash_attention.cu",
    "flash_attention_partials": _CSRC + "flash_attention.cu",
    "fused_mbconv_block": _CSRC + "fused_mbconv.cu",
    "fused_entry_block": _CSRC + "fused_entry.cu",
    "flash_gfold": _CSRC + "flash_attention.cu",
}
ENTRY_PER_FORWARD = {"fused_entry_block": 1, "fused_sepconv_block": 8, "fused_sepconv_chain": 4}
ENTRY_BATCHES = (1, 3, 16)  # K5 checks; also the entry-kernel forward's requests
GFOLD = (1, 4, 8)           # (batch, head) pairs per block for K3G
# E5's own shape (exp/vit_attn_variants.py) and ViT-B/16-384's, bf16.
GFOLD_SHAPES = ((32, 12, 256, 64), (16, 12, 576, 64))
B3_FUSED_PER_FORWARD = 18  # EfficientNet-B3's blocks on K4 at 300 px
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)  # the batching phase's server
LOAD_CLIENTS = 32   # closed-loop clients, one kept-alive connection each
LOAD_REQUESTS = 25  # one-image msgpack requests per client, each its own image
# The batching phase's arms: batching off, the scheduler's lane (what
# ``--batcher python`` and ``auto`` serve through) at depth 1 and at depth
# 2, and the C++ queue at depth 2; three runs of each in turns.
BATCH_ARMS = {"off": dict(use_batcher=False),
              "depth1": dict(pipeline_depth=1, batcher_impl="python"),
              "depth2": dict(pipeline_depth=2, batcher_impl="python"),
              "depth2-native": dict(pipeline_depth=2, batcher_impl="native")}
BATCH_ORDER = ("off", "depth1", "depth2", "depth2-native", "depth2-native", "depth2", "depth1",
               "off", "off", "depth1", "depth2", "depth2-native")
GRAPH_TOL = 1e-3  # relative, a bucket graph's replay vs the eager forward, if not bit-equal
# Kernel launches in a profiler trace of one replay of each served model's
# bucket graph (by kernel name): K1 runs sepconv_stage_kernel 3 times a
# block, K2 once a stage (block13 and block14: 2 stages each); K4 runs its
# three kernels once a block.
TRACE_KERNELS = {
    "clothing-model": {"sepconv_stage_kernel": 8 * 3 + 2 * 2},
    "vit-b16-384": {"flash_fwd_bf16": 12},
    "efficientnet-b3-imagenet": {k: 18 for k in ("mbconv_expand_dw_kernel", "mbconv_se_kernel",
                                                 "mbconv_proj_kernel")},
}
TRACE_MARK_CYCLES = 20_000_000  # the spin between a trace window's two replays (~10 ms)
TRACE_ATTEMPTS = 3  # device-resize traces retaken when a window lost its readback
# A library (cuDNN) convolution kernel in a trace: a name with one of these
# (the hand kernels' names, sepconv/mbconv/int8_conv, carry none of them).
_LIBRARY_CONV = ("fprop", "convolve", "conv2d_", "winograd")
# ResNet50 (BASELINE config 3) at 224 px: its buckets, and its bf16 logits'
# tolerance against the exact f32 graph (TF32 off), relative to the largest.
RESNET_BUCKETS = (1, 4, 16, 32)
RESNET_TOL = 2e-2
# The admission phase's overload A/B (the JAX bench's --overload-ab
# defaults): one-image requests at OVERLOAD_X times the batching phase's
# depth-2 img/s for OVERLOAD_S seconds, each with a OVERLOAD_DEADLINE_MS
# budget, from OVERLOAD_PROCESSES load processes of OVERLOAD_CONNECTIONS
# kept-alive connections; admission on, then off.
OVERLOAD_X = 2.0
OVERLOAD_S = 8.0
OVERLOAD_DEADLINE_MS = 600.0
OVERLOAD_PROCESSES = 4
OVERLOAD_CONNECTIONS = 128
DRAIN_CLIENTS = 16  # closed-loop clients on the server process SIGTERM drains
# The multimodel phase (the JAX bench's --multimodel-ab defaults): the heavy
# lane (ViT-B/16 at 384 px) offered MM_RATE_X times its img/s alone, in
# requests of MM_IMAGES images with a MM_HEAVY_DEADLINE_MS budget, from
# MM_HEAVY_PROCESSES load processes of MM_HEAVY_CONNECTIONS connections (a
# bounded pool, as a gateway's: with 512 connections, 512 handler threads
# decoding 3.5 MB bodies left the scheduler's threads short of the
# interpreter lock and the card 70% idle); the
# light lane (clothing-model) MM_LIGHT_RPS one-image requests a second with a
# MM_LIGHT_DEADLINE_MS budget; MM_SECONDS an arm.  ViT's img/s alone:
# MM_CALIBRATE (closed-loop clients, requests each) of MM_IMAGES images.
MM_RATE_X = 2.0
MM_IMAGES = 8
MM_HEAVY_DEADLINE_MS = 2000.0
MM_LIGHT_DEADLINE_MS = 300.0
MM_LIGHT_RPS = 40.0
MM_SECONDS = 8.0
MM_HEAVY_PROCESSES = 2
MM_HEAVY_CONNECTIONS = 32
MM_CALIBRATE = (8, 6)
# The reload phase: RELOAD_CLIENTS closed-loop one-image clients while
# versions land, the watcher scanning every RELOAD_WATCH_S, RELOAD_STEADY_S
# of load between swaps; memory after an unload within RELOAD_MEMORY_SLACK
# bytes of one version's.
RELOAD_CLIENTS = 16
RELOAD_WATCH_S = 0.5
RELOAD_STEADY_S = 2.0
RELOAD_MEMORY_SLACK = 16 << 20
# The observability phase: traced one-image requests, each span tree held to
# the JAX server's nesting and at least this share of server.request covered
# by its children; the closed loop behind the SLO, MFU and profile checks;
# the bucket-16 MFU gauge against an independent figure; the profile window
# and its stage-kernel launches per forward (K1: 3 stages, K2: 2), with two
# forwards of slack at each edge of the window; the cost loop's requests.
OBS_TRACED = 64
OBS_SPANS = ("server.request", "server.admission", "server.decode", "server.predict",
             "batcher.queue_wait", "pipeline.enqueue_wait", "pipeline.dispatch",
             "pipeline.execute", "pipeline.readback")
OBS_COVERAGE = 0.95
OBS_CLIENTS = 16
OBS_LOAD_S = 6.0
OBS_PROFILE_LOAD_S = 8.0  # covers the capture, its stop and its export
OBS_PROFILE_S = 2.0
OBS_MFU_BATCHES = 20
OBS_MFU_TOL = 0.25
OBS_STAGE_LAUNCHES = 8 * 3 + 2 * 2
OBS_EDGE_LAUNCHES = 2 * OBS_STAGE_LAUNCHES
OBS_COST_REQUESTS = 10_000
# The depth-2 arm's median img/s of the batching phase before the
# observability layer existed (an H100 80GB HBM3 at 700 W; another run of
# the same tree read 1,082).
DEPTH2_IMG_S_BEFORE = 940.0
# The gateway phase: the port's gateway (a process of its own) in front of
# the port's model server (buckets 1-32, depth 2, the scheduler's lane),
# on both wires: the bytes wire (the default: the server decodes) and the
# tensor wire (KDLT_INGEST=0 on the gateway: it decodes).  Images come from
# a local http.server: the committed JPEG/PNG fixtures (their PIL-decoded
# pixels beside them) and colour-grid PNGs written with zlib here.
GW_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           "ingest_fixtures")
# The decoder-breadth fixtures (progressive and 4-component JPEG, 4:4:0,
# 4:1:1, 16-bit and Adam7 PNG, large JPEGs) and their PIL digests.
FORMATS_DIR = os.path.join(GW_FIXTURES, "formats")
# Of them, served through both gateways beside the baseline fixtures.
GW_FORMAT_FIXTURES = ("prog_q75_420_123x77.jpg", "large_800x600_prog.jpg", "cmyk_q90_45x37.jpg",
                      "adam7_d16_type6_27x21.png")
FORMAT_DECODE_REPS = 15  # decodes of each large fixture timed, in turns (median)
# Device-resize staging (KDLT_INGEST_DEVICE_RESIZE) on clothing-model.
DR_STAGING = "512x512"
DR_BUCKETS = (1, 4, 16)
DR_ITERS = 20            # timed dispatches a bucket and route, in turns
DR_EXTRA_HW = ((480, 640), (768, 1024))  # generated PNG sizes beside the large fixtures
DR_EXTRA = 12            # generated PNGs (16 images with the four large fixtures)
GW_GRID_HW = (360, 480)  # the grid PNGs' size; nearest-resized to 299 x 299
GW_GRID_CELL = 24
GW_CHECK_GRIDS = 4       # grid PNGs held bit-equal against the tensor wire direct
GW_TRACED = 16           # sequential traced requests a wire, each its own image
GW_CLIENTS = (16, 32)    # closed-loop clients of the load runs
GW_IMAGES = 384          # distinct grid PNGs a load set (one set a client count)
# The image host, a process of its own: http.server's file handler with a
# listen backlog of 1024 (its default 5 drops the SYNs of a burst of
# fetches, each a new connection, and costs each a 1 s retransmit).
GW_IMAGE_SERVER = """
import functools, http.server, sys
class Server(http.server.ThreadingHTTPServer):
    request_queue_size = 1024
    daemon_threads = True
class Files(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass
Server(("127.0.0.1", int(sys.argv[1])), functools.partial(Files, directory=sys.argv[2])
       ).serve_forever()
"""
# The C5 gate: p99 of requests during a /debug/profile capture over p99 outside.
OBS_PROFILE_P99_RATIO = 3.0
# ViT-B/16 at its published fine-tuning resolution: 24 x 24 = 576 tokens.
VIT_384_KW = dict(name="vit-b16-384", family="vit-b16", input_shape=(384, 384, 3),
                  preprocessing="tf",
                  description="ViT-B/16 ImageNet classifier at 384 px (flash attention)")


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _stage_work(m: int, c_in: int, c_out: int) -> tuple[int, int, int]:
    """(bf16 GEMM FLOPs, f32 depthwise FLOPs, weight bytes) of one stage."""
    return 2 * m * c_in * c_out, 2 * 9 * m * c_in, 9 * c_in * 4 + c_in * c_out * 2 + 2 * c_out * 4


def _bound(m: int, widths: list[tuple[int, int]]) -> tuple[float, str]:
    """Least time (ms) for the call: each input read once, output written once."""
    gemm = dw = wbytes = 0
    for c_in, c_out in widths:
        g, d, b = _stage_work(m, c_in, c_out)
        gemm, dw, wbytes = gemm + g, dw + d, wbytes + b
    act = m * widths[0][0] * 2 + m * widths[-1][1] * 2
    t_bytes = (act + wbytes) / PEAK_BYTES
    t_ops = gemm / PEAK_BF16 + dw / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def _library_stage(y, s):
    """cuDNN depthwise + cuBLAS GEMM + affine: the yardstick, not the port."""
    if s["pre_relu"]:
        y = torch.relu(y)
    c = y.shape[-1]
    w = s["dw"].permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16)
    d = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), w, None, 1, 1, 1, c).permute(0, 2, 3, 1)
    z = torch.matmul(d, s["pw"]).float() * s["scale"] + s["shift"]
    if s["post_relu"]:
        z = torch.relu(z)
    return z.to(torch.bfloat16)


def _kernel_phase(params, iters: int, gen: torch.Generator) -> list[dict]:
    from kubernetes_deep_learning_tpu_torch import weights
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops

    dev = "cuda"
    p = {k: v.to(dev) for k, v in params.items()}
    batch = 16
    blocks = [
        dict(name="fused_sepconv_block", replaces="kubernetes_deep_learning_tpu/ops/fused_sepconv.py:192",
             calls=[((batch, 19, 19, 728), weights.middle_block_weights(p, "block5"))]),
        dict(name="fused_sepconv_chain", replaces="kubernetes_deep_learning_tpu/ops/fused_sepconv.py:307",
             calls=[
                 ((batch, 19, 19, 728), [weights.sepconv_stage_weights(
                     p, f"block13_sepconv{j}", f"block13_sepconv{j}_bn", True, False) for j in (1, 2)]),
                 ((batch, 10, 10, 1024), [weights.sepconv_stage_weights(
                     p, f"block14_sepconv{j}", f"block14_sepconv{j}_bn", False, True) for j in (1, 2)]),
             ]),
    ]
    records = []
    for k in blocks:
        rec = dict(name=k["name"], route="cuda", source=SOURCES[k["name"]], replaces=k["replaces"],
                   max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   library_ms=0.0, tol_rel=KERNEL_TOL, shapes=[])
        bound_t = {"bytes": 0.0, "operations": 0.0}
        for shape, w in k["calls"]:
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            if k["name"] == "fused_sepconv_block":
                stages = [dict(dw=w[0][i], pw=w[1][i], scale=w[2][i], shift=w[3][i],
                               pre_relu=True, post_relu=False) for i in range(3)]
                kernel = lambda x=x, w=w: ops.fused_sepconv_block(x, *w)  # noqa: E731
                plain = lambda x=x, w=w: ops.sepconv_block_reference(x, *w)  # noqa: E731

                def library(x=x, stages=stages):
                    y = x
                    for s in stages:
                        y = _library_stage(y, s)
                    return x + y
            else:
                stages = w
                kernel = lambda x=x, w=w: ops.fused_sepconv_chain(x, w)  # noqa: E731
                plain = lambda x=x, w=w: ops.sepconv_chain_reference(x, w)  # noqa: E731

                def library(x=x, stages=stages):
                    y = x
                    for s in stages:
                        y = _library_stage(y, s)
                    return y
            got = kernel().float()
            torch.cuda.synchronize()
            want = plain().float()
            if not torch.isfinite(got).all():
                _fail(f"{k['name']} at {shape}: non-finite output")
            err = (got - want).abs().max().item()
            rel = err / (want.abs().max().item() + 1e-6)
            if rel > KERNEL_TOL:
                _fail(f"{k['name']} at {shape}: relative error {rel:.3e} > {KERNEL_TOL}")
            m = shape[0] * shape[1] * shape[2]
            widths = [(s["pw"].shape[0], s["pw"].shape[1]) for s in stages]
            b_ms, b_by = _bound(m, widths)
            bound_t[b_by] += b_ms
            t = dict(shape=list(shape), widths=widths, max_abs_err=err, max_rel_err=rel,
                     ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     library_ms=_time_ms(library, iters), bound_ms=b_ms, bound_by=b_by)
            print("kernel-check", k["name"], json.dumps(t), flush=True)
            rec["shapes"].append(list(shape))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                rec[key] += t[key]
        rec["bound_by"] = max(bound_t, key=bound_t.get)
        rec["per"] = ("one call" if len(k["calls"]) == 1
                      else "the calls of one forward, summed")
        records.append(rec)
    return records


# Every (batch, side, C_in, C_out) at which the main paths launch the stage
# kernel, with the stage's relus: K1, K2 (and bucket 1), the entry path's
# blocks 3 and 4; and a wide image, 147x147 (the two stages K5 launched
# before it kept its sepconvs on chip; no path launches them now).
STAGE_SHAPES = (
    ("middle (K1)", 16, 19, 728, 728, True, False),
    ("middle (K1), bucket 1", 1, 19, 728, 728, True, False),
    ("block13 (K2)", 16, 19, 728, 1024, True, False),
    ("block14 (K2)", 16, 10, 1024, 1536, False, True),
    ("block14 (K2)", 16, 10, 1536, 2048, False, True),
    ("block14 (K2), bucket 1", 1, 10, 1536, 2048, False, True),
    ("entry block 3 (K2)", 16, 74, 128, 256, True, False),
    ("entry block 3 (K2)", 16, 74, 256, 256, True, False),
    ("entry block 4 (K2)", 16, 37, 256, 728, True, False),
    ("entry block 4 (K2)", 16, 37, 728, 728, True, False),
    ("wide 147x147 (no path)", 16, 147, 64, 128, False, True),
    ("wide 147x147 (no path)", 16, 147, 128, 128, False, False),
)


def _stage_phase(iters: int, gen: torch.Generator, smi: str) -> None:
    """One ``stage`` line per shape of STAGE_SHAPES: a single stage-kernel
    launch against its plain version (< KERNEL_TOL), its time beside the
    library stage and the bound, and the GEMM rate it reaches."""
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops

    def t(shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    for name, b, hw, c_in, c_out, pre, post in STAGE_SHAPES:
        x = t((b, hw, hw, c_in)).to(torch.bfloat16)
        s = dict(dw=t((3, 3, c_in), 0.2), pw=(t((c_in, c_out), c_in ** -0.5)).to(torch.bfloat16),
                 scale=t((c_out,), 0.1) + 1.0, shift=t((c_out,), 0.1), pre_relu=pre, post_relu=post)
        kernel = functools.partial(ops.fused_sepconv_chain, x, [s])
        got = kernel()
        torch.cuda.synchronize()
        err, rel = _rel(got, ops.sepconv_chain_reference(x, [s]))
        if not torch.isfinite(got.float()).all() or rel > KERNEL_TOL:
            _fail(f"stage {name} {(b, hw, c_in, c_out)}: relative error {rel:.3e} > {KERNEL_TOL}")
        m = b * hw * hw
        ms = _time_ms(kernel, iters)
        b_ms, b_by = _bound(m, [(c_in, c_out)])
        print("stage", json.dumps(dict(
            name=name, m=m, c_in=c_in, c_out=c_out, ms=ms,
            library_ms=_time_ms(functools.partial(_library_stage, x, s), iters),
            bound_ms=b_ms, bound_by=b_by, gemm_tflops=2 * m * c_in * c_out / ms / 1e9,
            max_abs_err=err, max_rel_err=rel, card=smi)), flush=True)


def _rel(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / (want.float().abs().max().item() + 1e-6)


def _attention_bound(bh: int, sq: int, sk: int, d: int, nbytes: int, dtype: torch.dtype,
                     exp_rate: float) -> tuple[float, str, dict]:
    """Least time (ms) for one non-causal call: ``nbytes`` (each input
    read once, each output written once); QK^T and PV products on the
    tensor cores (bf16, or f32 as 3xTF32: three TF32 products each, the
    kernel's route); one exponential per score.  For f32 the products'
    time on the CUDA cores' FMA (``products_fma``) is listed beside them,
    not counted: the tensor-core route is the faster."""
    flops = 4 * bh * sq * sk * d
    t = {"bytes": nbytes / PEAK_BYTES,
         "products": flops / PEAK_BF16 if dtype == torch.bfloat16 else 3 * flops / PEAK_TF32,
         "exp": bh * sq * sk / exp_rate}
    top = max(t, key=t.get)
    terms = {k: v * 1e3 for k, v in t.items()}
    if dtype != torch.bfloat16:
        terms["products_fma"] = flops / PEAK_F32 * 1e3
    return t[top] * 1e3, ("bytes" if top == "bytes" else "operations"), terms


def _graph_ms(fn, iters: int) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph and
    replayed, so the host's launch cost (the Python wrapper, ctypes) does
    not enter it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def _flash_plan(shape, pairs: int = 1) -> dict:
    """The bf16 kernel's q-tile at ``shape`` (B, H, S, D) on this card."""
    from kubernetes_deep_learning_tpu_torch.ops import _build

    b, h, s, d = shape
    return {"q_tile_rows": _build.load().kdlt_flash_attention_q_tile(b, h, s, d, pairs)}


def _attention_phase(iters: int, gen: torch.Generator, exp_rate: float) -> dict:
    """K3 against its plain version; the record for the ``kernels`` line."""
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (B, H, Sq, Sk, D), dtype, flash_attention keywords, timed
        ((16, 12, 576, 576, 64), bf16, {}, True),   # the main path: ViT-B/16-384, batch 16
        ((16, 12, 576, 576, 64), f32, {}, True),    # the exact f32 graph's calls
        ((2, 3, 200, 330, 64), bf16, dict(causal=True, k_offset=-64), False),
        ((2, 3, 128, 128, 64), bf16, dict(causal=True, k_offset=10_000), False),  # all 0
        ((2, 3, 128, 128, 64), f32, dict(causal=True, k_offset=10_000), False),
        ((1, 4, 300, 300, 32), bf16, dict(causal=True), False),
        ((1, 2, 257, 257, 128), bf16, dict(kv_len=200), False),
        ((1, 2, 250, 190, 64), f32, dict(causal=True, k_offset=-30), False),
    ]
    rec = dict(name="flash_attention", route="cuda", source=SOURCES["flash_attention"],
               replaces="kubernetes_deep_learning_tpu/ops/attention.py:342",
               max_abs_err=0.0, max_rel_err=0.0, tol_rel=KERNEL_TOL, f32_tol_rel=F32_KERNEL_TOL,
               per="one call at (16, 12, 576, 64) bf16 (f32: the same call in f32); errors: "
                   "max over the checked cases; graph_ms: device time, CUDA-graph replay")
    for (b, h, sq, sk, d), dtype, kw, timed in cases:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        kernel = functools.partial(attn.flash_attention, q, k, v, **kw)
        plain = functools.partial(attn.flash_attention_reference, q, k, v, **kw)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        tol = KERNEL_TOL if dtype == bf16 else F32_KERNEL_TOL
        shape = dict(q=[b, h, sq, d], sk=sk, dtype=str(dtype).removeprefix("torch."), **kw)
        if not torch.isfinite(got).all():
            _fail(f"flash_attention {shape}: non-finite output")
        if kw.get("k_offset") == 10_000:
            if got.any() or want.any():
                _fail(f"flash_attention {shape}: a fully masked row is not exactly 0")
            err, rel = 0.0, 0.0
        else:
            err, rel = _rel(got, want)
            if rel > tol:
                _fail(f"flash_attention {shape}: relative error {rel:.3e} > {tol}")
        t = dict(shape, max_abs_err=err, max_rel_err=rel, tol_rel=tol)
        if timed:
            nbytes = q.element_size() * b * h * d * (2 * sq + 2 * sk)  # q, k, v, o
            b_ms, b_by, terms = _attention_bound(b * h, sq, sk, d, nbytes, dtype, exp_rate)
            library = lambda q=q, k=k, v=v: sdpa(q, k, v)  # noqa: E731
            t.update(ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     library_ms=_time_ms(library, iters), graph_ms=_graph_ms(kernel, iters),
                     library_graph_ms=_graph_ms(library, iters),
                     bound_ms=b_ms, bound_by=b_by, bound_terms_ms=terms)
            keys = ("ms", "plain_ms", "library_ms", "graph_ms", "library_graph_ms", "bound_ms",
                    "bound_by")
            if dtype == bf16:
                t.update(_flash_plan((b, h, sq, d)))
                rec.update({key: t[key] for key in (*keys, "q_tile_rows")})
            else:
                rec["f32"] = {key: t[key] for key in keys}
        print("kernel-check flash_attention", json.dumps(t), flush=True)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    # Host cost of one operand's tensor map (the bf16 kernel encodes three a launch).
    from kubernetes_deep_learning_tpu_torch.ops import _build

    main = torch.empty((16, 576, 12, 64), dtype=bf16, device="cuda")
    rec["tensor_map_encode_us"] = _build.load().kdlt_flash_map_encode_us(
        main.data_ptr(), 16, 576, 12, 64, 1000)
    return rec


def _post(url: str, images: np.ndarray, wire: str) -> tuple[np.ndarray, list, float]:
    """One ``:predict``; returns (logits, labels, ms)."""
    from kubernetes_deep_learning_tpu_torch.serving import protocol

    body, ctype = _encode(images, wire)
    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        reply, reply_type = r.read(), r.headers.get("Content-Type", "")
    ms = (time.perf_counter() - t0) * 1e3
    logits, labels = protocol.decode_predict_response(reply, reply_type)
    return logits, labels, ms


def _encode(images: np.ndarray, wire: str) -> tuple[bytes, str]:
    from kubernetes_deep_learning_tpu_torch.serving import protocol

    if wire == "json":
        return json.dumps({"instances": images.tolist()}).encode(), protocol.JSON_CONTENT_TYPE
    return protocol.encode_predict_request(images), protocol.MSGPACK_CONTENT_TYPE


def _one_image_ms(port: int, path: str, image: np.ndarray, wire: str, iters: int) -> dict:
    """p50 of a 1-image ``:predict``: a fresh connection per request
    (``_post``) against one kept-alive ``http.client`` connection, in
    turns.  Their gap is connection set-up and any Nagle/delayed-ACK stall."""
    import http.client

    body, ctype = _encode(image, wire)
    fresh, kept = [], []
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        for _ in range(iters):
            fresh.append(_post(f"http://127.0.0.1:{port}{path}", image, wire)[2])
            t0 = time.perf_counter()
            conn.request("POST", path, body, {"Content-Type": ctype})
            resp = conn.getresponse()
            resp.read()
            kept.append((time.perf_counter() - t0) * 1e3)
            if resp.status != 200:
                _fail(f"keep-alive :predict answered {resp.status}")
    finally:
        conn.close()
    return dict(fresh_p50_ms=float(np.median(fresh)), keep_alive_p50_ms=float(np.median(kept)),
                requests=iters)


def _profile(model: str, fn, batch: int, steps: int = 5) -> float:
    """Device time by kernel over ``steps`` calls of ``fn`` (each ending
    in a device sync): engine predicts or training steps.  Returns the
    device ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (the CPU ops' totals would count each kernel twice).
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print("profile:", json.dumps({
        "model": model, "batch": batch, "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms / steps,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
    }), flush=True)
    for e in rows[:12]:
        print("profile-kernel:", json.dumps({
            "model": model, "name": e.key[:90], "calls_per_step": e.count / steps,
            "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
            "share": e.self_device_time_total / 1e3 / device_ms if device_ms else None,
        }), flush=True)
    return device_ms / steps


def _eager_predict(engine, imgs: np.ndarray) -> np.ndarray:
    """The same work as ``engine.predict`` on a full bucket, with the forward
    module called eagerly instead of the bucket's graph replayed."""
    with torch.inference_mode():
        return engine._forward(torch.from_numpy(imgs).to(engine.device)).cpu().numpy()


def _bucket_times(engine, name: str, b: int, imgs: np.ndarray, iters: int) -> dict:
    """p50 and img/s of ``engine.predict`` on one bucket-sized batch (its
    graph replayed), and in turns the p50 of the same work run eagerly."""
    for _ in range(2):
        engine.predict(imgs)
        _eager_predict(engine, imgs)
    lat, eager = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.predict(imgs)  # ends in a device sync (event + copy)
        t1 = time.perf_counter()
        _eager_predict(engine, imgs)
        eager.append((time.perf_counter() - t1) * 1e3)
        lat.append((t1 - t0) * 1e3)
    return dict(model=name, bucket=b, p50_ms=float(np.median(lat)),
                img_per_s=b * len(lat) / (sum(lat) / 1e3), eager_p50_ms=float(np.median(eager)))


def _graph_check(engine, name: str, seed: int) -> dict:
    """Each bucket's graph against the eager forward module on the same
    zero-padded batch (a quarter of the rows padding): bit-equal, or within
    GRAPH_TOL relative (then the run reports which bucket was not)."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in engine.buckets:
        n = max(1, b - b // 4)
        imgs = rng.integers(0, 256, (n, *engine.spec.input_shape), np.uint8)
        handle, _ = engine.predict_async(imgs)
        rows = np.asarray(handle).copy()
        padded = np.zeros((b, *engine.spec.input_shape), np.uint8)
        padded[:n] = imgs
        eager = _eager_predict(engine, padded)
        rel = float(np.abs(rows - eager).max() / (np.abs(eager).max() + 1e-6))
        if not np.isfinite(rows).all() or rel > GRAPH_TOL:
            _fail(f"{name}: bucket {b}'s graph replay vs the eager forward: relative {rel:.3e} "
                  f"> {GRAPH_TOL}")
        out[str(b)] = dict(images=n, bit_equal=bool(np.array_equal(rows, eager)), rel=rel)
    return dict(model=name, buckets=out, tol_rel=GRAPH_TOL,
                all_bit_equal=all(v["bit_equal"] for v in out.values()))


def _trace_check(engine, name: str, seed: int, expected: dict | None = None) -> dict:
    """One replay of the largest bucket's graph under ``torch.profiler``: each
    of the ``expected`` kernels (default TRACE_KERNELS[name]) must appear the
    expected number of times.  The window holds two replays with a spin
    kernel and a sync between them, and counts the second replay's kernels
    only (those that start after the spin ends, on the same stream): in a
    process that has traced before, the profiler can lose the first kernels
    of a window (ResNet50 w8a8's stem Q1 among them; a spin before the
    first replay did not always prevent it).  Also returns that replay's
    library convolution kernels by name (``library_convs``) and the CUDA
    records before and after the spin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    expected = expected if expected is not None else TRACE_KERNELS[name]
    imgs = np.random.default_rng(seed).integers(
        0, 256, (engine.max_batch, *engine.spec.input_shape), np.uint8)
    np.asarray(engine.predict_async(imgs)[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        np.asarray(engine.predict_async(imgs)[0])
        torch.cuda._sleep(TRACE_MARK_CYCLES)
        torch.cuda.synchronize()
        np.asarray(engine.predict_async(imgs)[0])
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
    if not marks:
        _fail(f"{name}: the traced window holds no spin kernel")
    replay = [e.name for e in events if e.time_range.start >= max(marks)]
    seen = {k: sum(k in n for n in replay) for k in expected}
    if seen != expected:
        _fail(f"{name}: one traced replay launched {seen}, expected {expected}")
    library_convs: dict[str, int] = {}
    for n in replay:
        if any(w in n.lower() for w in _LIBRARY_CONV):
            library_convs[n[:120]] = library_convs.get(n[:120], 0) + 1
    return dict(model=name, bucket=engine.max_batch, kernels=seen, library_convs=library_convs,
                records=dict(before_spin=len(events) - len(replay), replay=len(replay)))


def _unfused_check(spec, vdir: str, batches, replies, counter, iters: int, profile: bool) -> dict:
    """The same requests on a ``fast=False`` bf16 engine (the exact graph):
    no kernel of ``counter`` may launch, the fused route's logits must be
    within KERNEL_TOL of it; then its largest bucket's p50."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    engine = InferenceEngine(art.load_artifact(vdir), buckets=BUCKETS, device="cuda", fast=False)
    if engine.fast:
        _fail(f"{spec.name}: a fast=False engine took the fused path")
    engine.warmup()
    graphs = _graph_check(engine, f"{spec.name}-unfused", len(batches))
    counter.reset_launch_counts()
    worst = 0.0
    for imgs, (got, _, _) in zip(batches, replies):
        want = engine.predict(imgs)
        worst = max(worst, float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6)))
    if any(counter.launch_counts().values()):
        _fail(f"{spec.name}: the fast=False engine launched {counter.launch_counts()}")
    if worst > KERNEL_TOL:
        _fail(f"{spec.name}: fused route vs fast=False bf16: relative error {worst:.3e} "
              f"> {KERNEL_TOL}")
    b = BUCKETS[-1]
    imgs = np.random.default_rng(b).integers(0, 256, (b, *spec.input_shape), np.uint8)
    times = _bucket_times(engine, f"{spec.name}-unfused", b, imgs, iters)
    if profile:
        _profile(f"{spec.name}-unfused", functools.partial(engine.predict, imgs), b)
    return dict(fused_vs_unfused_bf16_rel=worst, tol_rel=KERNEL_TOL, graphs=graphs, **times)


def _server_phase(spec, variables, seed: int, iters: int, profile: bool, *, counter,
                  per_forward: dict, fast: bool, wire: str,
                  unfused: bool = False) -> tuple[dict, list[dict]]:
    """Serve ``spec`` through the port's model server on the card; the
    requests must launch ``per_forward`` kernels (``counter``'s counts) per
    forward, and the engine must (not) take the fused fast path.  With
    ``unfused``, also hold the replies against a ``fast=False`` engine."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as root:
        vdir = art.version_dir(root, spec.name, 1)
        art.save_artifact(vdir, spec, variables, {"compute_dtype": "bfloat16"})
        server = ModelServer(root, port=0, buckets=BUCKETS, device="cuda")
        try:
            server.start()
            engine = server.engines[spec.name]
            if engine.fast != fast:
                _fail(f"{spec.name}: engine.fast is {engine.fast}, expected {fast}")
            t0 = time.perf_counter()
            server.warmup()  # a graph per bucket: the main path below replays them
            warm_s = time.perf_counter() - t0
            memory = dict(model=spec.name, buckets=list(BUCKETS),
                          graph_pool_mib=engine.graph_memory_bytes() / 2**20,
                          reserved_mib_after_warmup=torch.cuda.memory_reserved() / 2**20)
            url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
            batches = [rng.integers(0, 256, (n, *spec.input_shape), np.uint8) for n in REQUESTS]

            # --- the main path: HTTP -> engine -> forward -> kernels ---
            counter.reset_launch_counts()
            replies = [_post(url, imgs, wire) for imgs in batches]
            launches = counter.launch_counts()

            # Every other kernel of ``counter`` must not launch at all.
            want = {name: per_forward.get(name, 0) * len(REQUESTS) for name in launches}
            if launches != want or not set(per_forward) <= set(launches):
                _fail(f"{spec.name}: kernel launches {launches} != {want} "
                      f"for {len(REQUESTS)} forwards")
            worst = 0.0
            for imgs, (got, labels, _ms) in zip(batches, replies):
                if got.shape != (len(imgs), spec.num_classes) or labels != list(spec.labels):
                    _fail(f"{spec.name}: logits shape {got.shape} for a batch of {len(imgs)}")
                if not np.isfinite(got).all():
                    _fail(f"{spec.name}: non-finite logits")
                exact = engine.predict(normalize(torch.from_numpy(imgs), spec.preprocessing).numpy())
                rel = float(np.abs(got - exact).max() / (np.abs(exact).max() + 1e-6))
                worst = max(worst, rel)
            if worst > MODEL_TOL:
                _fail(f"{spec.name}: bf16 path vs exact f32 graph: relative error "
                      f"{worst:.3e} > {MODEL_TOL}")

            graphs = _graph_check(engine, spec.name, seed + 5)
            traced = _trace_check(engine, spec.name, seed + 6)
            one_image = _one_image_ms(server.port, f"/v1/models/{spec.name}:predict",
                                      batches[0], wire, iters)
            buckets = []
            for b in BUCKETS:
                imgs = rng.integers(0, 256, (b, *spec.input_shape), np.uint8)
                buckets.append(_bucket_times(engine, spec.name, b, imgs, iters))
            if profile:
                _profile(spec.name, functools.partial(engine.predict, imgs), len(imgs))
        finally:
            server.shutdown()
        summary = dict(model=spec.name, wire=wire, fast=fast, warmup_s=warm_s, launches=launches,
                       graphs=graphs, trace_launches=traced, graph_memory=memory,
                       bf16_vs_exact_rel=worst, tol_rel=MODEL_TOL,
                       request_ms={str(len(i)): ms for i, (_, _, ms) in zip(batches, replies)},
                       one_image_request=one_image)
        if unfused:
            summary["unfused"] = _unfused_check(spec, vdir, batches, replies, counter, iters,
                                                profile)
    return summary, buckets


def _grid_images(spec, n: int, seed: int) -> np.ndarray:
    """``n`` distinct images: a colour from a 10-level RGB grid (each used
    once) plus uniform noise of +-24.  A random-weight model answers
    similar noise images with near-equal logits; distinct colours keep
    every pair of images apart, so a reply wired to another request shows."""
    rng = np.random.default_rng(seed)
    levels = np.linspace(0, 255, 10).round()
    grid = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    colour = grid[rng.permutation(len(grid))[:n]][:, None, None, :]
    noise = rng.integers(-24, 25, (n, *spec.input_shape))
    return np.clip(colour + noise, 0, 255).astype(np.uint8)


def _model_value(server, name: str, model: str) -> float:
    """One ``model``-labelled sample of the server's registry (a counter,
    or a histogram's ``_sum`` or ``_count``); a served version's series
    also carry its ``version``."""
    found = re.search(rf'^{name}\{{model="{re.escape(model)}"(?:,version="\d+")?\}} (\S+)$',
                      server.registry.render(), re.M)
    if found is None:
        _fail(f"no {name} series for {model}")
    return float(found.group(1))


def _loadgen_cmd(url: str, images_path: str | None, out_path: str, *args) -> list[str]:
    """The load generator's command line (``args``: its other options; no
    ``--images`` for its gateway mode, ``--image-urls``)."""
    images = ["--images", images_path] if images_path is not None else []
    return [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
            "--url", url, *images, "--out", out_path, *map(str, args)]


def _load_run(url: str, images_path: str | None, out_path: str, timeout: float,
              *args) -> dict:
    """The load generator in a process of its own (no shared interpreter
    lock with the server); returns its results.  ``args``: its options,
    LOAD_CLIENTS closed-loop clients of LOAD_REQUESTS requests if none."""
    args = args or ("--clients", LOAD_CLIENTS, "--requests", LOAD_REQUESTS)
    done = subprocess.run(_loadgen_cmd(url, images_path, out_path, *args), capture_output=True,
                          text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if done.returncode != 0:
        _fail(f"load generator exited {done.returncode}: {done.stderr[-2000:]}")
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def _event_wait_probe(sm_mhz: float) -> dict:
    """Host CPU time a thread spends in ``Event.synchronize()`` while the
    card sleeps 50 ms: the default event against ``blocking=True`` (the
    one the engine's handles use)."""
    out = {}
    for name, blocking in (("default", False), ("blocking", True)):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(0.05 * sm_mhz * 1e6))
        ev = torch.cuda.Event(blocking=blocking)
        ev.record()
        c0, w0 = time.thread_time(), time.perf_counter()
        ev.synchronize()
        out[f"{name}_wait_ms"] = (time.perf_counter() - w0) * 1e3
        out[f"{name}_cpu_ms"] = (time.thread_time() - c0) * 1e3
    return out


def _batching_phase(spec, variables, seed: int, smi: str, *, counter, per_forward: dict,
                    device: str = "cuda", profile: bool = False) -> list[dict]:
    """Single-image traffic through the port's server in four arms
    (BATCH_ARMS): batching off, the scheduler's lane at depth 1 and at depth
    2, and the C++ queue at depth 2 (``--batcher native``: a queue that will not build
    fails the run), each run three times in turns (BATCH_ORDER) by the load
    generator.  Each bucket graph of the depth-2 engine is first held
    against the eager forward.  Every
    reply must lie within MODEL_TOL of the exact f32 graph for its own
    image, and nearer to that image's logits alone (bucket 1, the same
    engine) than to any other image's; every forward must
    launch ``per_forward`` kernels of ``counter``.  On the card, one more
    run of each depth-2 arm is traced for the device's busy share, and the
    dispatch stage is timed with no load beside it, beside the copy of the
    batch into a staging slot alone; with ``profile``, its host side is
    traced too (host time by op)."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    arms = BATCH_ARMS
    n = LOAD_CLIENTS * LOAD_REQUESTS
    images = _grid_images(spec, n, seed + 2)
    servers: dict = {}
    lines = []
    with tempfile.TemporaryDirectory() as root:
        art.save_artifact(art.version_dir(root, spec.name, 1), spec, variables,
                          {"compute_dtype": "bfloat16"})
        images_path = f"{root}/images.npy"
        np.save(images_path, images)
        try:
            for arm, kw in arms.items():
                servers[arm] = ModelServer(root, port=0, buckets=BATCH_BUCKETS, device=device,
                                           **kw)
                servers[arm].start()
                servers[arm].warmup()
            engine = servers["depth2"].engines[spec.name]
            graphs = _graph_check(engine, spec.name, seed + 7)
            print("batching-graph:", json.dumps({**graphs, "card": smi}), flush=True)
            step = engine.max_batch
            exact = np.concatenate([
                engine.predict(normalize(torch.from_numpy(images[i : i + step]),
                                         spec.preprocessing).numpy())
                for i in range(0, n, step)])
            scale = np.abs(exact).max(axis=1)
            # The wiring reference: each image alone through the same bf16
            # engine (bucket 1).  Its bf16-vs-f32 error is as large as the
            # gap between two similar images' logits, so a reply is matched
            # to its image against these, not against the exact graph.
            solo = np.concatenate([engine.predict(images[k : k + 1]) for k in range(n)])
            apart = np.abs(solo[:, None, :] - solo[None, :, :]).max(axis=2) / scale[None, :]
            np.fill_diagonal(apart, np.inf)
            stages = ["kdlt_engine_infer_seconds"] + [
                f"kdlt_pipeline_{k}_seconds" for k in ("enqueue_wait", "dispatch", "execute",
                                                       "readback")]
            for run, arm in enumerate(BATCH_ORDER):
                server = servers[arm]
                url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
                series = [f"kdlt_engine_{k}_total" for k in ("images", "batches", "pad_images")]
                series += [f"{h}_{agg}" for h in stages for agg in ("sum", "count")]
                # The dispatcher's stages: none on this path with batching off.
                series = [m for m in series if m.startswith("kdlt_engine_") or arm != "off"]
                before = {m: _model_value(server, m, spec.name) for m in series}
                counter.reset_launch_counts()
                res = _load_run(url, images_path, f"{root}/run{run}.npz", timeout=600)
                launches = counter.launch_counts()
                delta = {m: _model_value(server, m, spec.name) - v for m, v in before.items()}
                got = {k: delta[f"kdlt_engine_{k}_total"]
                       for k in ("images", "batches", "pad_images")}
                # Mean ms per batch of the engine's dispatch->sync and of each
                # dispatcher stage (none at depth 1: no dispatcher).
                stage_ms = {h.replace("kdlt_", "").replace("_seconds", ""):
                            1e3 * delta[f"{h}_sum"] / max(delta[f"{h}_count"], 1)
                            for h in stages if f"{h}_sum" in delta}
                if (res["status"] != 200).any():
                    _fail(f"batching {arm}: statuses {sorted(set(res['status'].tolist()))}")
                forwards = int(got["batches"])
                want = {name: per_forward.get(name, 0) * forwards for name in launches}
                if got["images"] != n or launches != want:
                    _fail(f"batching {arm}: {got['images']:.0f} images, launches {launches} "
                          f"!= {want} for {forwards} forwards")
                logits = res["logits"]
                rel = np.abs(logits - exact).max(axis=1) / scale
                # Reply k against every image's solo logits: its own must be nearest.
                to_all = np.abs(logits[:, None, :] - solo[None, :, :]).max(axis=2) / scale[None, :]
                misplaced = int((to_all.argmin(axis=1) != np.arange(n)).sum())
                if not np.isfinite(logits).all() or rel.max() > MODEL_TOL or misplaced:
                    _fail(f"batching {arm}: worst reply vs its exact f32 logits {rel.max():.3e} "
                          f"(tol {MODEL_TOL}), {misplaced} replies nearer another image's")
                lat = res["lat_ms"]
                lines.append(dict(
                    arm=arm, run=run, requests=n, clients=LOAD_CLIENTS,
                    img_per_s=n / float(res["wall_s"]), p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)), forwards=forwards,
                    mean_batch=n / forwards, padding_rows=int(got["pad_images"]),
                    launches=launches, stage_ms=stage_ms, worst_rel=float(rel.max()),
                    tol_rel=MODEL_TOL, worst_vs_solo_rel=float(to_all.diagonal().max()),
                    nearest_other_image_rel=float(apart.min()), card=smi))
                print("batching:", json.dumps(lines[-1]), flush=True)
            for arm in arms:
                runs = [line for line in lines if line["arm"] == arm]
                print("batching-arm:", json.dumps({
                    "arm": arm, "runs": len(runs),
                    **{f"median_{k}": float(np.median([r[k] for r in runs]))
                       for k in ("img_per_s", "p50_ms", "p99_ms", "mean_batch")},
                    "card": smi}), flush=True)
            if device == "cuda":
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                # The dispatch stage with no load beside it: one predict_async
                # (the copy into a staging slot, the H2D copy and the graph's
                # replay), then its sync; and the copy into the slot alone.
                alone, copy = {}, {}
                for b in (16, 32):
                    times, copies = [], []
                    slot = engine.lend_staging()
                    for _ in range(ITERS):
                        t0 = time.perf_counter()
                        handle, _ = engine.predict_async(images[:b])
                        times.append((time.perf_counter() - t0) * 1e3)
                        np.asarray(handle)
                        t0 = time.perf_counter()
                        slot.array[:b] = images[:b]
                        copies.append((time.perf_counter() - t0) * 1e3)
                    engine.return_staging(slot)
                    alone[str(b)] = float(np.median(times))
                    copy[str(b)] = float(np.median(copies))
                for arm in ("depth2", "depth2-native"):
                    url = f"http://127.0.0.1:{servers[arm].port}/v1/models/{spec.name}:predict"
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        res = _load_run(url, images_path, f"{root}/traced.npz", timeout=600)
                    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                                    if e.device_type == DeviceType.CUDA) / 1e3
                    wall_ms = float(res["wall_s"]) * 1e3
                    print("batching-profile:", json.dumps({
                        "arm": arm, "wall_ms": wall_ms, "device_ms": device_ms,
                        "device_busy_share": device_ms / wall_ms,
                        "img_per_s": n / float(res["wall_s"]), "dispatch_alone_ms": alone,
                        "staging_copy_ms": copy, "card": smi}), flush=True)
                if profile:
                    _dispatch_host_profile(engine, images[:16])
        finally:
            for server in servers.values():
                server.shutdown()
    return lines


def _kernel_modules() -> tuple:
    """Every hand kernel's wrapper module (each keeps its launch counts)."""
    from kubernetes_deep_learning_tpu_torch.ops import (
        attention,
        fused_entry,
        fused_mbconv,
        fused_sepconv,
        int8,
    )

    return fused_sepconv, attention, fused_mbconv, fused_entry, int8


def _resnet_phase(seed: int, iters: int, profile: bool, smi: str) -> dict:
    """``resnet50-imagenet`` at full width and depth (224 px, 16 bottleneck
    blocks), random weights from ``seed``, bf16, served by the port's model
    server with buckets RESNET_BUCKETS.  Its path runs cuDNN convolutions and
    none of the hand kernels: a 3-image msgpack ``:predict`` (the main path)
    must launch none, and return the engine's logits for the same images bit
    for bit.  Every bucket's graph must replay bit-equal to the eager forward
    (the stem's padded conv and max-pool captured); the bf16 logits must lie
    within RESNET_TOL of the exact f32 graph.  Then graph and eager p50 and
    img/s per bucket, and with ``profile`` the device ms at bucket 16."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.modelspec import RESNET50_IMAGENET as spec
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    rng = np.random.default_rng(seed + 3)
    with tempfile.TemporaryDirectory() as root:
        art.save_artifact(art.version_dir(root, spec.name, 1), spec,
                          init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"})
        server = ModelServer(root, port=0, buckets=RESNET_BUCKETS, device="cuda")
        try:
            server.start()
            engine = server.engines[spec.name]
            if engine.fast:
                _fail(f"{spec.name}: the engine took a fused path; ResNet50 has none")
            t0 = time.perf_counter()
            server.warmup()
            warm_s = time.perf_counter() - t0
            graphs = _graph_check(engine, spec.name, seed + 5)
            if not graphs["all_bit_equal"]:
                _fail(f"{spec.name}: a bucket graph's replay is not bit-equal to eager: {graphs}")
            print("graph:", json.dumps({**graphs, "card": smi}), flush=True)

            # --- the main path: HTTP -> engine -> graph replay (cuDNN, no hand kernel) ---
            imgs = rng.integers(0, 256, (3, *spec.input_shape), np.uint8)
            url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
            for m in _kernel_modules():
                m.reset_launch_counts()
            got, labels, request_ms = _post(url, imgs, "msgpack")
            launches = {k: v for m in _kernel_modules() for k, v in m.launch_counts().items()}
            if any(launches.values()):
                _fail(f"{spec.name}: its path launched hand kernels: {launches}")
            if got.shape != (3, spec.num_classes) or labels != list(spec.labels):
                _fail(f"{spec.name}: logits shape {got.shape}")
            if not np.isfinite(got).all():
                _fail(f"{spec.name}: non-finite logits")
            direct = engine.predict(imgs)
            if not np.array_equal(got, direct):
                _fail(f"{spec.name}: the HTTP reply differs from the engine's logits")
            exact = engine.predict(normalize(torch.from_numpy(imgs), spec.preprocessing).numpy())
            rel = float(np.abs(got - exact).max() / (np.abs(exact).max() + 1e-6))
            if rel > RESNET_TOL:
                _fail(f"{spec.name}: bf16 vs exact f32 graph: relative {rel:.3e} > {RESNET_TOL}")

            buckets, device_ms = [], None
            for b in RESNET_BUCKETS:
                batch = rng.integers(0, 256, (b, *spec.input_shape), np.uint8)
                buckets.append(_bucket_times(engine, spec.name, b, batch, iters))
                print("resnet-bucket:", json.dumps({**buckets[-1], "card": smi}), flush=True)
                if profile and b == 16:
                    device_ms = _profile(spec.name, functools.partial(engine.predict, batch), b)
            memory_mib = engine.graph_memory_bytes() / 2**20
        finally:
            server.shutdown()
    return dict(model=spec.name, buckets=list(RESNET_BUCKETS), warmup_s=warm_s,
                graphs_bit_equal=graphs["all_bit_equal"], launches=launches,
                request_ms=request_ms, http_equals_engine=True, bf16_vs_exact_rel=rel,
                tol_rel=RESNET_TOL, graph_pool_mib=memory_mib,
                device_ms_bucket16=device_ms, card=smi)


def _drained(server, name: str, timeout_s: float) -> bool:
    """Wait until no admitted request is in flight, ``name``'s lane has
    nothing queued and none of its plans is still dispatching or on the
    card; False on timeout."""
    deadline = time.monotonic() + timeout_s
    if not server.admission.wait_idle(timeout_s=timeout_s):
        return False
    lane = server.scheduler.lane(name)
    while lane.pending_images:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return server.scheduler.wait_engine_idle(lane.engine, max(deadline - time.monotonic(), 0))


def _overload_run(url: str, images_path: str, out_path: str, rate: float) -> dict:
    """The open-loop load generator (OVERLOAD_PROCESSES processes) at
    ``rate``; returns its per-request results."""
    cmd = [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
           "--url", url, "--images", images_path, "--rate", f"{rate:.1f}",
           "--duration", str(OVERLOAD_S), "--deadline-ms", str(OVERLOAD_DEADLINE_MS),
           "--processes", str(OVERLOAD_PROCESSES), "--connections", str(OVERLOAD_CONNECTIONS),
           "--out", out_path]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if done.returncode != 0:
        _fail(f"open-loop load generator exited {done.returncode}: {done.stderr[-2000:]}")
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def _check_replies(arm: str, res: dict, solo: np.ndarray) -> dict:
    """Every 200 carries its own image's logits (nearest to that image's
    solo logits of all images, within MODEL_TOL of them); every 503 and 504
    has a JSON body; every 503 a Retry-After inside the limiter's jittered
    range; nothing else but unsent or lost requests."""
    from kubernetes_deep_learning_tpu_torch.serving.admission import limiter

    status = res["status"]
    bad = sorted(set(status.tolist()) - {0, -1, 200, 503, 504})
    if bad:
        _fail(f"overload {arm}: replies with status {bad}")
    shed = np.isin(status, (503, 504))
    if not res["json_body"][shed].all():
        _fail(f"overload {arm}: {int((~res['json_body'][shed]).sum())} 503/504 without JSON")
    lo = limiter.RETRY_AFTER_MIN_S * (1 - limiter.RETRY_AFTER_JITTER)
    hi = limiter.RETRY_AFTER_MAX_S * (1 + limiter.RETRY_AFTER_JITTER)
    hints = res["retry_after_s"][status == 503]
    if not ((hints >= lo) & (hints <= hi)).all():
        _fail(f"overload {arm}: Retry-After outside [{lo}, {hi}]: "
              f"{sorted(set(hints[~((hints >= lo) & (hints <= hi))].tolist()))[:5]}")
    ok = np.flatnonzero(status == 200)
    scale = np.abs(solo).max(axis=1)
    misplaced, worst = 0, 0.0
    for i in range(0, len(ok), 1024):
        rows = ok[i : i + 1024]
        got, own = res["logits"][rows], res["image"][rows]
        to_all = np.abs(got[:, None, :] - solo[None, :, :]).max(axis=2) / scale[None, :]
        misplaced += int((to_all.argmin(axis=1) != own).sum())
        worst = max(worst, float(to_all[np.arange(len(rows)), own].max()))
    if not np.isfinite(res["logits"][ok]).all() or misplaced or worst > MODEL_TOL:
        _fail(f"overload {arm}: {misplaced} replies nearer another image's logits, worst vs "
              f"its own {worst:.3e} (tol {MODEL_TOL})")
    return dict(replies_200=len(ok), worst_vs_solo_rel=worst, retry_after_range=[lo, hi],
                retry_after_seen=[float(hints.min()), float(hints.max())] if len(hints) else None)


def _drain_phase(root: str, spec, images: np.ndarray, solo: np.ndarray) -> dict:
    """A server process (``python -m ...serving.model_server``) under
    DRAIN_CLIENTS closed-loop clients gets SIGTERM: /readyz must turn 503
    "draining", new predicts 503 "draining" (JSON, ``Retry-After: 1.000``),
    every request sent before them complete with 200 and its own image's
    logits, none be lost, and the process exit 0."""
    import http.client
    import signal
    import socket
    import threading

    from kubernetes_deep_learning_tpu_torch.serving import protocol

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log_path = os.path.join(root, "drain-server.log")
    path = f"/v1/models/{spec.name}:predict"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.model_server",
             "--model-root", root, "--host", "127.0.0.1", "--port", str(port),
             "--buckets", ",".join(map(str, BUCKETS)), "--device", "cuda"],
            stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        while True:  # wait for readiness (warmup captures every bucket's graph)
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                _fail(f"drain: the server process did not become ready (rc {proc.poll()}): "
                      f"{open(log_path).read()[-2000:]}")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                    if r.status == 200:
                        break
            except OSError:
                pass
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        print(f"drain: server process ready in {ready_s:.1f} s", flush=True)
        replies: list = []  # (client, image, status, reason, retry_after, logits)
        lost: list = []
        readyz: list = []
        stop_poll, termed, give_up = threading.Event(), threading.Event(), threading.Event()

        def client(c: int) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            headers = {"Content-Type": protocol.MSGPACK_CONTENT_TYPE}
            k = c
            try:
                while not give_up.is_set():
                    i = k % len(images)
                    conn.request("POST", path, protocol.encode_predict_request(images[i : i + 1]),
                                 headers)
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status == 200:
                        replies.append((c, i, 200, "", None, protocol.decode_predict_response(
                            body, resp.getheader("Content-Type"))[0][0]))
                    else:
                        try:
                            reason = json.loads(body).get("shed_reason", "")
                        except ValueError:
                            reason = "not-json"
                        replies.append((c, i, resp.status, reason,
                                        resp.getheader("Retry-After"), None))
                        return  # a shed: this client stops
                    k += DRAIN_CLIENTS
            except (OSError, http.client.HTTPException) as e:
                lost.append((c, repr(e)))
            finally:
                conn.close()

        def poll_readyz() -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            try:
                while not stop_poll.is_set():
                    conn.request("GET", "/readyz")
                    resp = conn.getresponse()
                    readyz.append((termed.is_set(), resp.status, resp.read().decode()))
                    time.sleep(0.002)
            except (OSError, http.client.HTTPException):
                pass  # the process has gone
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(DRAIN_CLIENTS)]
        poller = threading.Thread(target=poll_readyz, daemon=True)
        for t in [*threads, poller]:
            t.start()
        time.sleep(2.0)  # load on the server
        served_before = sum(1 for r in replies if r[2] == 200)
        termed.set()
        proc.send_signal(signal.SIGTERM)
        until = time.monotonic() + 60
        for t in threads:
            t.join(timeout=max(0.0, until - time.monotonic()))
        give_up.set()  # a client still sending a minute after SIGTERM: the drain failed
        print(f"drain: clients done ({len(replies)} replies, {len(lost)} lost, "
              f"{sum(t.is_alive() for t in threads)} still sending)", flush=True)
        rc = proc.wait(timeout=60)
        stop_poll.set()
        poller.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    statuses = {}
    for r in replies:
        key = f"{r[2]} {r[3]}".strip()
        statuses[key] = statuses.get(key, 0) + 1
    draining_readyz = sum(1 for after, st, body in readyz
                          if after and (st, body) == (503, "draining"))
    sheds = [r for r in replies if r[2] != 200]
    ok = [r for r in replies if r[2] == 200]
    scale = np.abs(solo).max(axis=1)
    worst = max((float(np.abs(r[5] - solo[r[1]]).max() / scale[r[1]]) for r in ok), default=0.0)
    out = dict(model=spec.name, clients=DRAIN_CLIENTS, ready_s=ready_s, exit_code=rc,
               replies=statuses, served_before_sigterm=served_before, lost=len(lost),
               readyz_before=sum(1 for after, st, _ in readyz if not after and st == 200),
               readyz_draining=draining_readyz, worst_vs_solo_rel=worst)
    if (rc != 0 or lost or not sheds or draining_readyz == 0 or worst > MODEL_TOL
            or any((r[2], r[3], r[4]) != (503, "draining", "1.000") for r in sheds)):
        _fail(f"drain: {out}; lost {lost[:3]}; server log: {open(log_path).read()[-2000:]}")
    return out


def _admission_phase(spec, variables, seed: int, smi: str, depth2_img_s: float, *,
                     counter, per_forward: dict) -> dict:
    """The port server's admission front door on the card, serving ``spec``
    through its kernels (``counter``, ``per_forward`` launches a forward)
    with BATCH_BUCKETS at depth 2 (the batching phase's depth-2 arm):

    (a) a request with ``X-Request-Deadline-Ms: 0`` gets a JSON 504, and the
    engine's image counter does not move;
    (b) the overload A/B: open-loop one-image load at OVERLOAD_X x
    ``depth2_img_s`` for OVERLOAD_S s, OVERLOAD_DEADLINE_MS a request, once
    with admission on and once with ``--no-admission``: offered rate
    achieved, goodput, in-deadline p50/p99, sheds by reason, the limiter's
    final limit, and the JAX bench's criterion (goodput on >= off and
    in-deadline p99 on < off) as a measurement, not a gate; every reply
    checked (``_check_replies``) and the kernels' launches per forward;
    (c) drain (``_drain_phase``)."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.serving import loadgen, protocol
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    n_images = LOAD_CLIENTS * LOAD_REQUESTS
    images = _grid_images(spec, n_images, seed + 2)
    rate = OVERLOAD_X * depth2_img_s
    out: dict = {"rate_target": rate, "depth2_img_per_s": depth2_img_s}
    with tempfile.TemporaryDirectory() as root:
        art.save_artifact(art.version_dir(root, spec.name, 1), spec, variables,
                          {"compute_dtype": "bfloat16"})
        images_path = os.path.join(root, "images.npy")
        np.save(images_path, images)
        servers = {}
        try:
            for arm, admission in (("on", None), ("off", False)):
                servers[arm] = ModelServer(root, port=0, buckets=BATCH_BUCKETS, device="cuda",
                                           pipeline_depth=2, batcher_impl="python",
                                           admission=admission)
                servers[arm].start()
                servers[arm].warmup()
            on = servers["on"]
            if not on.admission.enabled or servers["off"].admission.enabled:
                _fail("admission: the arms' admission settings are wrong")
            engine = on.engines[spec.name]
            solo = np.concatenate([engine.predict(images[k : k + 1]) for k in range(n_images)])

            # (a) a spent budget: a JSON 504 before the engine is touched
            before = _model_value(on, "kdlt_engine_images_total", spec.name)
            req = urllib.request.Request(
                f"http://127.0.0.1:{on.port}/v1/models/{spec.name}:predict",
                data=protocol.encode_predict_request(images[:1]), method="POST",
                headers={"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
                         "X-Request-Deadline-Ms": "0"})
            try:
                urllib.request.urlopen(req, timeout=30)
                _fail("admission: a spent budget was served")
            except urllib.error.HTTPError as e:
                body = json.loads(e.read())
                if e.code != 504 or body.get("shed_reason") != "deadline_exhausted":
                    _fail(f"admission: a spent budget got {e.code} {body}")
            if _model_value(on, "kdlt_engine_images_total", spec.name) != before:
                _fail("admission: the 504 moved the engine's image counter")
            out["deadline_504"] = dict(status=504, images_moved=0)

            # (b) the overload A/B
            arms = {}
            for arm in ("on", "off"):
                server = servers[arm]
                url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
                batches0 = _model_value(server, "kdlt_engine_batches_total", spec.name)
                counter.reset_launch_counts()
                res = _overload_run(url, images_path, os.path.join(root, f"{arm}.npz"), rate)
                # Requests the clients gave up on may still be queued: count
                # launches and batches once every admitted one has finished
                # and the lane has run what their handlers left behind (a
                # handler whose wait timed out leaves its unit queued).
                if not _drained(server, spec.name, 60):
                    _fail(f"overload {arm}: requests still in flight 60 s after the load")
                launches = counter.launch_counts()
                forwards = int(_model_value(server, "kdlt_engine_batches_total", spec.name)
                               - batches0)
                want = {k: per_forward.get(k, 0) * forwards for k in launches}
                if not forwards or launches != want:
                    _fail(f"overload {arm}: launches {launches} != {want} for {forwards} "
                          f"forwards")
                arms[arm] = dict(arm=arm, **loadgen.summarize(res),
                                 limit=server.admission.limit, forwards=forwards,
                                 launches=launches, **_check_replies(arm, res, solo), card=smi)
                print("overload:", json.dumps(arms[arm]), flush=True)
            p99 = {a: arms[a]["p99_in_deadline_ms"] for a in arms}
            out["jax_criterion"] = bool(
                arms["on"]["goodput_rps"] >= arms["off"]["goodput_rps"]
                and p99["on"] is not None
                and (p99["off"] is None or p99["on"] < p99["off"]))
            out["overload"] = {a: {k: arms[a][k] for k in (
                "offered_rps", "goodput_rps", "p50_in_deadline_ms", "p99_in_deadline_ms",
                "status", "shed", "limit")} for a in arms}
        finally:
            for server in servers.values():
                server.shutdown()
        print("admission: overload servers stopped", flush=True)
        # (c) drain: SIGTERM a server process under load
        out["drain"] = _drain_phase(root, spec, images, solo)
    print("drain:", json.dumps({**out["drain"], "card": smi}), flush=True)
    return {**out, "card": smi}


def _mm_check(arm: str, name: str, res: dict, solo: np.ndarray, exact: np.ndarray,
              per_request: int) -> dict:
    """Every 200 of ``name`` carries its own images' logits (of all images'
    solo logits, its own are the nearest) within MODEL_TOL of the exact f32
    graph; every other reply is a JSON 503 or 504, or was never sent or
    lost (status 0 or -1)."""
    status = res["status"]
    bad = sorted(set(status.tolist()) - {0, -1, 200, 503, 504})
    if bad:
        _fail(f"multimodel {arm} {name}: replies with status {bad}")
    shed = np.isin(status, (503, 504))
    if not res["json_body"][shed].all():
        _fail(f"multimodel {arm} {name}: {int((~res['json_body'][shed]).sum())} 503/504 "
              "without a JSON body")
    ok = np.flatnonzero(status == 200)
    logits = res["logits"][ok].reshape(-1, solo.shape[1])
    own = (res["image"][ok][:, None] + np.arange(per_request)[None, :]).reshape(-1)
    scale_solo, scale_exact = np.abs(solo).max(axis=1), np.abs(exact).max(axis=1)
    misplaced, worst = 0, 0.0
    for i in range(0, len(own), 1024):
        got, idx = logits[i : i + 1024], own[i : i + 1024]
        to_all = np.abs(got[:, None, :] - solo[None, :, :]).max(axis=2) / scale_solo[None, :]
        misplaced += int((to_all.argmin(axis=1) != idx).sum())
        if len(idx):
            worst = max(worst, float((np.abs(got - exact[idx]).max(axis=1)
                                      / scale_exact[idx]).max()))
    if not np.isfinite(logits).all() or misplaced or worst > MODEL_TOL:
        _fail(f"multimodel {arm} {name}: {misplaced} images nearer another image's logits, "
              f"worst vs its exact f32 logits {worst:.3e} (tol {MODEL_TOL})")
    return dict(replies_200=len(ok), worst_vs_exact_rel=worst, tol_rel=MODEL_TOL)


def _interleave_check(server, images: dict, seed: int) -> dict:
    """Batches of both models replayed in turn through the server's shared
    dispatcher (depth 2: one of each in flight at once) must equal each
    model's batch replayed alone, bit for bit."""
    rng = np.random.default_rng(seed)
    plan = []
    for n in (1, 3, *BATCH_BUCKETS[-3:], 5):
        for name, imgs in images.items():
            plan.append((name, imgs[rng.permutation(len(imgs))[:n]]))
    solo = [server.engines[name].predict(imgs) for name, imgs in plan]
    futs = [server.dispatcher.submit(imgs, engine=server.engines[name], model=name)
            for name, imgs in plan]
    unequal = [i for i, (fut, want) in enumerate(zip(futs, solo))
               if not np.array_equal(fut.result(timeout=120), want)]
    if unequal:
        _fail(f"multimodel: interleaved replays {unequal} differ from the solo replays")
    return dict(batches=len(plan), sizes=[len(imgs) for _, imgs in plan], bit_equal=True)


def _mm_load(url: str, images_path: str, out_path: str, *, rate: float, deadline_ms: float,
             per_request: int, processes: int, connections: int, start_at: float):
    cmd = [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
           "--url", url, "--images", images_path, "--rate", f"{rate:.3f}",
           "--duration", str(MM_SECONDS), "--deadline-ms", str(deadline_ms),
           "--images-per-request", str(per_request), "--processes", str(processes),
           "--connections", str(connections), "--start-at", repr(start_at), "--out", out_path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _multimodel_phase(clothing, vit, seed: int, smi: str) -> dict:
    """``clothing-model`` (K1, K2) and ``vit-b16-384`` (K3) on one server:
    buckets 1-32, depth 2, admission off, so the scheduler alone arbitrates
    (as the JAX bench's --multimodel-ab).  First ViT's img/s alone
    (closed loop, MM_CALIBRATE clients x requests of MM_IMAGES images) and
    the interleave check (``_interleave_check``); then one server per
    policy, weighted_deadline and then fifo, each for MM_SECONDS under two
    open-loop loads on one schedule: ViT at MM_RATE_X x its img/s in
    requests of MM_IMAGES (MM_HEAVY_DEADLINE_MS), clothing-model at
    MM_LIGHT_RPS one-image requests (MM_LIGHT_DEADLINE_MS).  Per model and
    arm: offered, completed and in-deadline requests, goodput as a fraction
    of offered, in-deadline p50/p99; per arm the worst model's goodput and
    the device's busy share (a CUDA trace of the arm).  Gates: replies
    (``_mm_check``), and 8 K1, 2 K2 and 12 K3 launches a forward of their
    model.  JAX's criterion is printed, not gated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
    from kubernetes_deep_learning_tpu_torch.serving import loadgen
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    per_forward = {clothing.name: {"fused_sepconv_block": 8, "fused_sepconv_chain": 2},
                   vit.name: {"flash_attention": 12}}
    clients, requests = MM_CALIBRATE
    images = {clothing.name: _grid_images(clothing, int(MM_LIGHT_RPS * MM_SECONDS), seed + 12),
              vit.name: _grid_images(vit, clients * requests * MM_IMAGES, seed + 11)}
    plans = {clothing.name: dict(per_request=1, deadline_ms=MM_LIGHT_DEADLINE_MS,
                                 processes=1, connections=32),
             vit.name: dict(per_request=MM_IMAGES, deadline_ms=MM_HEAVY_DEADLINE_MS,
                            processes=MM_HEAVY_PROCESSES, connections=MM_HEAVY_CONNECTIONS)}
    out: dict = {"card": smi}
    arms: dict = {}
    with tempfile.TemporaryDirectory() as root:
        for spec in (clothing, vit):
            art.save_artifact(art.version_dir(root, spec.name, 1), spec,
                              init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"})
        paths = {name: os.path.join(root, f"{name}.npy") for name in images}
        for name, imgs in images.items():
            np.save(paths[name], imgs)
        for policy in ("weighted_deadline", "fifo"):
            t0 = time.perf_counter()
            server = ModelServer(root, port=0, buckets=BATCH_BUCKETS, device="cuda",
                                 pipeline_depth=2, admission=False, sched_policy=policy)
            try:
                server.start()
                server.warmup()
                if server.scheduler is None or server.scheduler.policy != policy:
                    _fail(f"multimodel: the {policy} server has no {policy} scheduler")
                urls = {name: f"http://127.0.0.1:{server.port}/v1/models/{name}:predict"
                        for name in images}
                print(f"multimodel: {policy} server warm in {time.perf_counter() - t0:.1f} s",
                      flush=True)
                if policy == "weighted_deadline":
                    solo, exact = {}, {}
                    for name, imgs in images.items():
                        engine = server.engines[name]
                        step = engine.max_batch
                        exact[name] = np.concatenate([
                            engine.predict(normalize(torch.from_numpy(imgs[i : i + step]),
                                                     engine.spec.preprocessing).numpy())
                            for i in range(0, len(imgs), step)])
                        solo[name] = np.concatenate([engine.predict(imgs[k : k + 1])
                                                     for k in range(len(imgs))])
                    out["interleave"] = _interleave_check(server, images, seed + 14)
                    print("multimodel-interleave:", json.dumps({**out["interleave"], "card": smi}),
                          flush=True)
                    cal_path = os.path.join(root, "calibrate.npz")
                    done = subprocess.run(
                        [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
                         "--url", urls[vit.name], "--images", paths[vit.name], "--clients",
                         str(clients), "--requests", str(requests), "--images-per-request",
                         str(MM_IMAGES), "--out", cal_path],
                        capture_output=True, text=True, timeout=300,
                        cwd=os.path.dirname(os.path.abspath(__file__)))
                    if done.returncode != 0:
                        _fail(f"multimodel: calibration load exited {done.returncode}: "
                              f"{done.stderr[-2000:]}")
                    with np.load(cal_path) as z:
                        cal = {k: z[k] for k in z.files}
                    if (cal["status"] != 200).any():
                        _fail(f"multimodel: calibration statuses {sorted(set(cal['status']))}")
                    n_cal = clients * requests
                    cal["image"] = np.arange(n_cal) * MM_IMAGES
                    cal["json_body"] = np.ones(n_cal, bool)
                    _mm_check("calibration", vit.name, cal, solo[vit.name], exact[vit.name],
                              MM_IMAGES)
                    vit_img_s = n_cal * MM_IMAGES / float(cal["wall_s"])
                    out["calibration"] = dict(
                        model=vit.name, clients=clients, requests=n_cal,
                        images_per_request=MM_IMAGES, img_per_s=vit_img_s,
                        p50_ms=float(np.percentile(cal["lat_ms"], 50)),
                        p99_ms=float(np.percentile(cal["lat_ms"], 99)))
                    print("multimodel-calibration:", json.dumps({**out["calibration"],
                                                                 "card": smi}), flush=True)
                    rates = {clothing.name: MM_LIGHT_RPS,
                             vit.name: MM_RATE_X * vit_img_s / MM_IMAGES}
                batches0 = {name: _model_value(server, "kdlt_engine_batches_total", name)
                            for name in images}
                fused_sepconv.reset_launch_counts()
                attn.reset_launch_counts()
                start_at = time.time() + 1.5 + 0.2 * MM_HEAVY_PROCESSES
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    procs = {name: _mm_load(urls[name], paths[name],
                                            os.path.join(root, f"{policy}-{name}.npz"),
                                            rate=rates[name], start_at=start_at, **plans[name])
                             for name in images}
                    for name, proc in procs.items():
                        _, err = proc.communicate(timeout=300)
                        if proc.returncode != 0:
                            _fail(f"multimodel {policy}: {name}'s load exited "
                                  f"{proc.returncode}: {err[-2000:]}")
                    # Requests the clients gave up on may still be queued:
                    # count once every one has left the server.
                    if not server.admission.wait_idle(timeout_s=120):
                        _fail(f"multimodel {policy}: requests in flight 120 s after the load")
                    torch.cuda.synchronize()
                    window_s = time.time() - start_at
                device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                                if e.device_type == DeviceType.CUDA) / 1e3
                launches = {**fused_sepconv.launch_counts(), **attn.launch_counts()}
                forwards = {name: int(_model_value(server, "kdlt_engine_batches_total", name)
                                      - batches0[name]) for name in images}
                want = {k: sum(per_forward[name].get(k, 0) * forwards[name] for name in images)
                        for k in launches}
                if launches != want or not all(forwards.values()):
                    _fail(f"multimodel {policy}: launches {launches} != {want} for forwards "
                          f"{forwards}")
                models = {}
                for name in images:
                    with np.load(os.path.join(root, f"{policy}-{name}.npz")) as z:
                        res = {k: z[k] for k in z.files}
                    summary = loadgen.summarize(res)
                    offered = len(res["status"])
                    models[name] = dict(
                        offered=offered, offered_rps=summary["offered_rps"],
                        sent=summary["sent"], completed=summary["completed_200"],
                        in_deadline=summary["in_deadline"],
                        goodput_frac=summary["in_deadline"] / max(offered, 1),
                        goodput_rps=summary["goodput_rps"],
                        p50_in_deadline_ms=summary["p50_in_deadline_ms"],
                        p99_in_deadline_ms=summary["p99_in_deadline_ms"],
                        status=summary["status"], shed=summary["shed"],
                        images_per_request=plans[name]["per_request"],
                        deadline_ms=plans[name]["deadline_ms"], forwards=forwards[name],
                        **_mm_check(policy, name, res, solo[name], exact[name],
                                    plans[name]["per_request"]))
                arms[policy] = dict(
                    policy=policy, seconds=MM_SECONDS, rates=rates, models=models,
                    worst_model_goodput_frac=min(m["goodput_frac"] for m in models.values()),
                    launches=launches, device_ms=device_ms, window_s=window_s,
                    device_busy_share=device_ms / (window_s * 1e3), card=smi)
                print("multimodel:", json.dumps(arms[policy]), flush=True)
            finally:
                server.shutdown()
    w, f = arms["weighted_deadline"], arms["fifo"]
    ratio = w["worst_model_goodput_frac"] / max(f["worst_model_goodput_frac"], 1e-9)
    heavy_ok = (w["models"][vit.name]["goodput_frac"]
                >= 0.8 * f["models"][vit.name]["goodput_frac"])
    out.update(arms={p: {k: a[k] for k in ("worst_model_goodput_frac", "device_busy_share")}
                     | {"goodput_frac": {n: m["goodput_frac"] for n, m in a["models"].items()}}
                     for p, a in arms.items()},
               worst_model_ratio=ratio, jax_criterion=bool(ratio >= 1.2 and heavy_ok))
    return out


def _reload_phase(spec, seed: int, smi: str, *, counter, per_forward: dict) -> dict:
    """``spec`` (clothing-model, K1 and K2) v1 served with buckets 1-32 under
    RELOAD_CLIENTS closed-loop one-image clients (the load generator, a
    process of its own), the version watcher scanning every RELOAD_WATCH_S.
    v2 (weights from ``seed`` + 1), v3 (``seed`` + 2) and v4 (a byte copy of
    v3) land in turn, each renamed into place whole, RELOAD_STEADY_S of load
    apart.  Gates: every request is answered 200; every reply names its
    version by ``X-Kdlt-Artifact-Hash`` and carries that version's logits
    for its image (nearest among every version's and image's, within
    MODEL_TOL of its version's solo logits); a request sent one scan after
    a swap gets the new version; the hash and ``:status`` change at v2 and
    v3 and not at v4, which keeps the engine object (no capture); /readyz
    answers 200 throughout; after each unload ``memory_allocated`` is within
    RELOAD_MEMORY_SLACK of its value with v1 alone; 8 K1 and 2 K2 launches
    a dispatch.  Recorded: allocated, peak and reserved memory, each swap's
    seconds and warmup seconds, and the p99 inside the reload windows
    against steady state."""
    import shutil
    import threading

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer
    from kubernetes_deep_learning_tpu_torch.serving.registry import artifact_hash

    n = 256
    images = _grid_images(spec, n, seed + 13)
    name = spec.name
    with tempfile.TemporaryDirectory() as root:
        model_dir = os.path.join(root, name)
        staged = {v: art.save_artifact(os.path.join(model_dir, f".staged-{v}"), spec,
                                       init_variables(spec, seed=seed + v - 1),
                                       {"compute_dtype": "bfloat16"})
                  for v in (1, 2, 3)}
        # Each version's logits of each image alone (bucket 1), from an
        # engine of its own, closed before the server starts.
        refs = {}
        for v, d in staged.items():
            engine = InferenceEngine(art.load_artifact(d), buckets=(1,), device="cuda")
            engine.warmup()
            refs[v] = np.concatenate([engine.predict(images[k : k + 1]) for k in range(n)])
            engine.close()
        hashes = {v: artifact_hash(d) for v, d in staged.items()}
        version_of = {h: v for v, h in hashes.items()}
        os.rename(staged[1], art.version_dir(root, name, 1))
        images_path = os.path.join(root, "images.npy")
        np.save(images_path, images)
        server = ModelServer(root, port=0, buckets=BATCH_BUCKETS, device="cuda")
        readyz: list = []
        stop_poll = threading.Event()
        stop_file = os.path.join(root, "stop")
        try:
            server.start()
            server.warmup()
            server.start_version_watcher(RELOAD_WATCH_S)
            torch.cuda.synchronize()
            base = dict(allocated=torch.cuda.memory_allocated(),
                        reserved=torch.cuda.memory_reserved())

            def poll_readyz() -> None:
                while not stop_poll.is_set():
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{server.port}/readyz", timeout=10) as r:
                            readyz.append(r.status)
                    except urllib.error.HTTPError as e:
                        readyz.append(e.code)
                    except OSError:
                        readyz.append(-1)
                    time.sleep(0.01)

            poller = threading.Thread(target=poll_readyz, daemon=True)
            poller.start()
            counter.reset_launch_counts()
            dispatches0 = _model_value(server, "kdlt_sched_dispatch_total", name)
            proc = subprocess.Popen(
                [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.loadgen",
                 "--url", f"http://127.0.0.1:{server.port}/v1/models/{name}:predict",
                 "--images", images_path, "--clients", str(RELOAD_CLIENTS),
                 "--requests", "5000", "--duration", "300", "--stop-file", stop_file,
                 "--out", os.path.join(root, "load.npz")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            time.sleep(RELOAD_STEADY_S)
            swaps = []
            for v in (2, 3, 4):
                old = server.models[name]
                if v == 4:
                    src = shutil.copytree(art.version_dir(root, name, 3),
                                          os.path.join(model_dir, ".staged-4"))
                else:
                    src = staged[v]
                torch.cuda.reset_peak_memory_stats()
                t_write = time.time()
                os.rename(src, art.version_dir(root, name, v))
                deadline = time.monotonic() + 120
                while server.models[name].version != v:
                    if time.monotonic() > deadline or proc.poll() is not None:
                        _fail(f"reload: v{v} was not adopted within 120 s")
                    time.sleep(0.005)
                with server.model_registry._lock:  # the scan that swapped (and unloaded) is over
                    t_swap = time.time()
                torch.cuda.synchronize()
                status = json.loads(server.handle_get(f"/v1/models/{name}:status")[1])
                new = server.models[name]
                swaps.append(dict(
                    version=v, t_write=t_write, t_swap=t_swap, swap_s=t_swap - t_write,
                    warmup_s=new.warmup_s if new is not old else None,
                    same_engine=new.engine is old.engine, old_engine_closed=old.engine._closed,
                    status_version=status["version"], status_hash=status["artifact_hash"],
                    allocated=torch.cuda.memory_allocated(),
                    peak_allocated=torch.cuda.max_memory_allocated(),
                    reserved=torch.cuda.memory_reserved()))
                print("reload-swap:", json.dumps({**swaps[-1], "card": smi}), flush=True)
                time.sleep(RELOAD_STEADY_S)
            with open(stop_file, "w"):
                pass
            _, err = proc.communicate(timeout=120)
            if proc.returncode != 0:
                _fail(f"reload: the load exited {proc.returncode}: {err[-2000:]}")
            launches = counter.launch_counts()
            dispatches = int(_model_value(server, "kdlt_sched_dispatch_total", name) - dispatches0)
        finally:
            stop_poll.set()
            server.shutdown()
        with np.load(os.path.join(root, "load.npz")) as z:
            res = {k: z[k] for k in z.files}
    sent = res["status"] != 0
    status, lat = res["status"][sent], res["lat_ms"][sent]
    sent_at, image = res["sent_at"][sent], res["image"][sent]
    logits, served_hash = res["logits"][sent], res["artifact_hash"][sent]
    if (status != 200).any():
        _fail(f"reload: failed requests: {sorted(set(status.tolist()))}")
    unknown = sorted(set(served_hash.tolist()) - set(version_of))
    if unknown:
        _fail(f"reload: replies name artifacts no version has: {unknown[:3]}")
    served = np.array([version_of[h] for h in served_hash])
    # Each reply against every version's and image's solo logits: its own
    # version's row for its own image must be the nearest, within MODEL_TOL.
    table = np.concatenate([refs[v] for v in (1, 2, 3)])
    scale = np.abs(table).max(axis=1)
    wrong, worst = 0, 0.0
    for i in range(0, len(image), 512):
        got = logits[i : i + 512]
        own = (served[i : i + 512] - 1) * n + image[i : i + 512]
        rel = np.abs(got[:, None, :] - table[None, :, :]).max(axis=2) / scale[None, :]
        wrong += int((rel.argmin(axis=1) != own).sum())
        worst = max(worst, float(rel[np.arange(len(own)), own].max()))
    if wrong or worst > MODEL_TOL or not np.isfinite(logits).all():
        _fail(f"reload: {wrong} replies nearer another version's or image's logits, worst vs "
              f"its own {worst:.3e} (tol {MODEL_TOL})")
    # After a swap plus one scan, only the new version answers; before the
    # write, only the old one.
    late = []
    for s, prev in zip(swaps, (1, 2, 3)):
        want = min(s["version"], 3)
        after = sent_at > s["t_swap"] + RELOAD_WATCH_S
        nxt = [t["t_write"] for t in swaps if t["version"] > s["version"]]
        if nxt:
            after &= sent_at < nxt[0]
        before = res["done_at"][sent] < s["t_write"]
        if s["version"] > 2:
            before &= sent_at > swaps[s["version"] - 3]["t_swap"] + RELOAD_WATCH_S
        late += [(s["version"], "after", int((served[after] != want).sum())),
                 (s["version"], "before", int((served[before] != prev).sum()))]
    if any(k for _, _, k in late):
        _fail(f"reload: replies from the wrong version around a swap: {late}")
    v2, v3, v4 = swaps
    seen = [s["status_hash"] for s in swaps]
    if (seen != [hashes[2], hashes[3], hashes[3]] or len(set(hashes.values())) != 3
            or [s["status_version"] for s in swaps] != [2, 3, 4]):
        _fail(f"reload: :status hashes {[s['status_hash'][:12] for s in swaps]} versions "
              f"{[s['status_version'] for s in swaps]}")
    if v2["same_engine"] or v3["same_engine"] or not v4["same_engine"]:
        _fail("reload: v2 and v3 must bring new engines and v4 keep v3's")
    if not (v2["old_engine_closed"] and v3["old_engine_closed"]):
        _fail("reload: a superseded engine was not closed")
    drift = [s["allocated"] - base["allocated"] for s in swaps]
    if any(abs(d) >= RELOAD_MEMORY_SLACK for d in drift):
        _fail(f"reload: memory_allocated after the unloads differs by {drift} bytes from one "
              f"version's {base['allocated']}")
    if any(code != 200 for code in readyz) or not readyz:
        _fail(f"reload: /readyz answered {sorted(set(readyz))}")
    # A new version's warmup runs each bucket's forward twice: eagerly before
    # its capture, and the capture's first replay.
    forwards = dispatches + 2 * len(BATCH_BUCKETS) * sum(not s["same_engine"] for s in swaps)
    want = {k: per_forward.get(k, 0) * forwards for k in launches}
    if launches != want or not dispatches:
        _fail(f"reload: launches {launches} != {want} for {dispatches} dispatches and "
              f"{forwards - dispatches} warmup forwards")
    windows = np.zeros(len(sent_at), bool)
    for s in swaps:
        windows |= (sent_at >= s["t_write"]) & (sent_at <= s["t_swap"])
    pct = lambda x, q: float(np.percentile(x, q)) if len(x) else None  # noqa: E731
    return dict(
        model=spec.name, clients=RELOAD_CLIENTS, watch_interval_s=RELOAD_WATCH_S,
        requests=int(sent.sum()), all_200=True, worst_vs_own_rel=worst, tol_rel=MODEL_TOL,
        hashes={f"v{v}": h[:16] for v, h in hashes.items()},
        one_version=base, swaps=[{k: s[k] for k in s if not k.startswith("t_")} for s in swaps],
        allocated_drift_bytes=drift, memory_slack_bytes=RELOAD_MEMORY_SLACK,
        readyz_polls=len(readyz), readyz_all_200=True, dispatches=dispatches, launches=launches,
        p50_steady_ms=pct(lat[~windows], 50), p99_steady_ms=pct(lat[~windows], 99),
        p50_reload_window_ms=pct(lat[windows], 50), p99_reload_window_ms=pct(lat[windows], 99),
        requests_in_windows=int(windows.sum()), card=smi)


def _http_json(port: int, path: str, data: bytes | None = None,
               headers: dict | None = None) -> tuple[int, dict, dict]:
    """(status, JSON body, headers) of one request to the server."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST" if data is not None else "GET",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _span_tree_check(rid: str, spans: list[dict]) -> dict:
    """One traced request's spans against the JAX server's tree: the nine
    names, server.request over admission, decode and predict, the queue
    wait and the four stages under server.predict, the stages contiguous;
    returns each span's ms and the share of server.request its children
    cover."""
    by_name = {sp["name"]: sp for sp in spans}
    missing = [n for n in OBS_SPANS if n not in by_name]
    if len(spans) < len(OBS_SPANS) or missing:
        _fail(f"observability: trace {rid}: {len(spans)} spans, missing {missing}")
    root, predict = by_name["server.request"], by_name["server.predict"]
    wrong = [n for n in ("server.admission", "server.decode", "server.predict")
             if by_name[n]["parent_id"] != root["span_id"]]
    wrong += [n for n in OBS_SPANS[4:] if by_name[n]["parent_id"] != predict["span_id"]]
    stages = [by_name[n] for n in OBS_SPANS[5:]]
    gaps = [b["start_s"] - (a["start_s"] + a["dur_ms"] / 1e3) for a, b in zip(stages, stages[1:])]
    if wrong or any(abs(g) > 2e-6 for g in gaps):
        _fail(f"observability: trace {rid}: misparented {wrong}, stage gaps {gaps} s")
    children = sum(sp["dur_ms"] for sp in spans if sp["parent_id"] == root["span_id"])
    return {"ms": {n: by_name[n]["dur_ms"] for n in OBS_SPANS},
            "coverage": children / root["dur_ms"]}


def _metric_samples(text: str, name: str, model: str) -> dict[str, float]:
    """The ``model``-labelled samples of one series: label text -> value."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        rf'^{name}\{{model="{re.escape(model)}"([^}}]*)\}} (\S+)$', text, re.M)}


def _accounting_cost_us(n: int) -> float:
    """Host microseconds of the tracing and accounting of one reply, over
    ``n`` synthetic requests through the server's own ``_Exchange``: its
    three stage spans with the queue wait and four pipeline spans deferred
    under predict, the reply's id and ``X-Kdlt-Trace`` headers, then
    ``finish()`` (the latency histogram without exemplars, ``slo.record``,
    the root span, ``classify``)."""
    from types import SimpleNamespace

    from kubernetes_deep_learning_tpu_torch.serving.model_server import _Exchange
    from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib
    from kubernetes_deep_learning_tpu_torch.utils import slo as slo_lib
    from kubernetes_deep_learning_tpu_torch.utils import trace as trace_lib

    registry = metrics_lib.Registry()
    server = SimpleNamespace(
        tracer=trace_lib.Tracer("model-server", registry=registry),
        slo=slo_lib.SloEngine(registry, tier="model-server", enabled=True),
        _m_errors=registry.counter("kdlt_server_errors_total"),
        _m_latency=registry.histogram("kdlt_server_request_seconds"),
        request_log=False, recorder=None)
    t0 = time.perf_counter()
    for i in range(n):
        ex = _Exchange(server, {"X-Request-Id": f"cost-{i}", "X-Kdlt-Parent-Span": "feedbeef"})
        with ex.stage(trace_lib.SPAN_SERVER_ADMISSION):
            ex.model = "clothing-model"
        with ex.stage(trace_lib.SPAN_SERVER_DECODE, bytes=268_203):
            pass
        with ex.stage(trace_lib.SPAN_SERVER_PREDICT, batch=1) as pt:
            w = trace_lib.now_s()
            pt.defer(tuple((name, w, 1e-4, {}) for name in OBS_SPANS[4:]))
        ex.status, ex.batch, ex.w_end = 200, 1, trace_lib.now_s()
        ex.reply_headers()
        ex.finish()
    return (time.perf_counter() - t0) / n * 1e6


def _observability_phase(spec, seed: int, smi: str, depth2_img_s: float, *, counter,
                         per_forward: dict) -> dict:
    """``spec`` (clothing-model, K1 and K2) on its own server (buckets 1-32,
    depth 2, the scheduler's lane, admission on), with the observability
    layer: OBS_TRACED traced one-image requests, each span tree held to the
    JAX server's (``_span_tree_check``; at least OBS_COVERAGE of
    server.request covered by its children); OBS_CLIENTS closed-loop clients
    for OBS_LOAD_S, after which /debug/slo must count what the load
    generator saw, /metrics must carry ``kdlt_mfu_pct`` in (0, 100] for every
    bucket the audit saw served and ``kdlt_device_busy_ratio`` in (0, 1],
    and the bucket-16 gauge (after OBS_MFU_BATCHES 16-image requests) must
    lie within OBS_MFU_TOL of 16 x FLOPs/img / (the bucket graph's device
    ms by replay x peak); a /debug/profile of OBS_PROFILE_S inside a second
    load of OBS_PROFILE_LOAD_S, whose ``kernels`` must count
    OBS_STAGE_LAUNCHES stage-kernel launches per forward the launch counter
    credited (+- OBS_EDGE_LAUNCHES), with the p99 of requests inside the
    window against outside; then a declared stall, after which every
    request gets the stall 503 and exactly one incident bundle holds the
    first one's ``dispatch.stall`` event and its pinned trace.  Also the
    host cost of the per-reply accounting, and the batching phase's
    depth-2 img/s beside DEPTH2_IMG_S_BEFORE."""
    import http.client
    import threading

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import _native
    from kubernetes_deep_learning_tpu_torch.runtime import flops as flops_lib
    from kubernetes_deep_learning_tpu_torch.runtime.engine import capture_lock
    from kubernetes_deep_learning_tpu_torch.serving import protocol
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    name = spec.name
    images = _grid_images(spec, 512, seed + 17)
    out: dict = {"model": name, "card": smi}
    with tempfile.TemporaryDirectory() as root:
        art.save_artifact(art.version_dir(root, name, 1), spec, init_variables(spec, seed=seed),
                          {"compute_dtype": "bfloat16"})
        images_path = os.path.join(root, "images.npy")
        np.save(images_path, images)
        server = ModelServer(root, port=0, buckets=BATCH_BUCKETS, device="cuda",
                             profile_base=os.path.join(root, "profiles"),
                             incident_dir=os.path.join(root, "incidents"))
        url = f"http://127.0.0.1:{server.port}/v1/models/{name}:predict"
        path = f"/v1/models/{name}:predict"
        try:
            server.start()
            server.warmup()
            engine = server.engines[name]
            # --- traced requests: the per-request breakdown ---
            # One client, one kept-alive connection, one request at a time;
            # the traces are fetched after the last one, so that no fetch's
            # handler thread competes with a traced request for the
            # interpreter lock.
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=300)
            try:
                for i in range(OBS_TRACED):
                    rid = f"obs-{i}"
                    conn.request("POST", path, protocol.encode_predict_request(images[i : i + 1]),
                                 {"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
                                  "X-Request-Id": rid, "X-Kdlt-Parent-Span": "c0ffee00"})
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status != 200 or resp.getheader("X-Request-Id") != rid:
                        _fail(f"observability: traced request {rid}: {resp.status}, id "
                              f"{resp.getheader('X-Request-Id')}")
            finally:
                conn.close()
            trees = []
            for i in range(OBS_TRACED):
                rid, deadline = f"obs-{i}", time.monotonic() + 10
                while True:  # the root span closes just after the reply
                    status, info, _ = _http_json(server.port, f"/debug/trace/{rid}")
                    if status == 200 and any(sp["name"] == "server.request"
                                             for sp in info["spans"]):
                        break
                    if time.monotonic() > deadline:
                        _fail(f"observability: no root span for {rid}")
                    time.sleep(0.005)
                trees.append(_span_tree_check(rid, info["spans"]))
            coverage = [t["coverage"] for t in trees]
            out["traced"] = dict(
                requests=len(trees), min_spans=len(OBS_SPANS), min_coverage=min(coverage),
                median_coverage=float(np.median(coverage)),
                p5_coverage=float(np.percentile(coverage, 5)),
                median_ms={n: float(np.median([t["ms"][n] for t in trees])) for n in OBS_SPANS})
            print("observability-spans:", json.dumps({**out["traced"], "card": smi}), flush=True)
            if min(coverage) < OBS_COVERAGE:
                _fail(f"observability: children cover {min(coverage):.3f} of server.request "
                      f"(at least {OBS_COVERAGE})")

            # --- load: /debug/slo against the load generator's replies ---
            def slo_counts() -> dict:
                rows = _http_json(server.port, "/debug/slo")[1]["models"].get(name, {})
                return rows.get("1h", {})

            before = slo_counts()
            res = _load_run(url, images_path, os.path.join(root, "load.npz"), OBS_LOAD_S + 120,
                            *_obs_load_args(OBS_LOAD_S))
            sent = res["status"] != 0
            n200 = int((res["status"][sent] == 200).sum())
            deadline = time.monotonic() + 10
            while True:  # each request's SLO record follows its reply
                after = slo_counts()
                delta = {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("total", "good", "late", "shed", "error", "client")}
                if delta["total"] >= int(sent.sum()) or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
            if (delta["total"] != int(sent.sum()) or delta["good"] + delta["late"] != n200
                    or n200 != int(sent.sum())):
                _fail(f"observability: /debug/slo moved {delta}, the load generator saw "
                      f"{int(sent.sum())} replies, {n200} of them 200")
            out["load"] = dict(clients=OBS_CLIENTS, seconds=OBS_LOAD_S, requests=int(sent.sum()),
                               replies_200=n200, slo_delta=delta,
                               img_per_s=n200 / float(res["wall_s"]),
                               p99_ms=float(np.percentile(res["lat_ms"][sent], 99)))
            # --- MFU and busy gauges; the bucket audit ---
            for _ in range(OBS_MFU_BATCHES):  # bucket-16 batches for the gauge's EWMA
                _post(url, images[:16], "msgpack")
            status, audit, _ = _http_json(server.port, "/debug/profile?audit=buckets")
            served = {b: row for b, row in audit["models"][name]["buckets"].items()
                      if row["batches"]}
            text = server.handle_get("/metrics")[1].decode()
            mfu = {re.search(r'bucket="(\d+)"', k).group(1): v
                   for k, v in _metric_samples(text, "kdlt_mfu_pct", name).items()}
            busy = list(_metric_samples(text, "kdlt_device_busy_ratio", name).values())
            if (status != 200 or "16" not in served or any(b not in mfu for b in served)
                    or not all(0 < mfu[b] <= 100 for b in served)
                    or len(busy) != 1 or not 0 < busy[0] <= 1):
                _fail(f"observability: audit {status} served {sorted(served)}, kdlt_mfu_pct "
                      f"{mfu}, kdlt_device_busy_ratio {busy}")
            x16 = torch.from_numpy(images[:16]).cuda()
            with torch.inference_mode():
                graph16_ms = _graph_ms(lambda: engine._forward(x16), ITERS)
            flops_img = flops_lib.flops_per_image(spec)
            peak = flops_lib.peak_tflops(engine.device, "bfloat16")
            independent = 16 * flops_img / (graph16_ms * 1e-3 * peak * 1e12) * 100
            if abs(mfu["16"] / independent - 1) > OBS_MFU_TOL:
                _fail(f"observability: kdlt_mfu_pct at bucket 16 {mfu['16']} vs {independent:.3f} "
                      f"from the graph's {graph16_ms:.3f} ms (tolerance {OBS_MFU_TOL})")
            out["mfu"] = dict(
                gauge_pct=mfu, bucket16_independent_pct=independent, bucket16_graph_ms=graph16_ms,
                flops_per_image=flops_img, peak_tflops=peak, device_busy_ratio=busy[0],
                padding_waste={b: row["padding_waste_ratio"] for b, row in served.items()},
                mean_admitted={b: row["mean_admitted"] for b, row in served.items()})
            print("observability-mfu:", json.dumps({**out["mfu"], "card": smi}), flush=True)

            # --- /debug/profile inside a second load ---
            proc = subprocess.Popen(
                _loadgen_cmd(url, images_path, os.path.join(root, "profiled.npz"),
                             *_obs_load_args(OBS_PROFILE_LOAD_S)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            # The capture starts once the load is flowing (the generator's
            # process takes a moment to start), a quarter second in.
            requests0, deadline = server._m_requests.value, time.monotonic() + 60
            while server._m_requests.value < requests0 + 4 * OBS_CLIENTS:
                if time.monotonic() > deadline or proc.poll() is not None:
                    _fail("observability: the profiled load did not start")
                time.sleep(0.005)
            time.sleep(0.25)
            # The launch counts at the recording's own start and stop (the
            # request's edges add its set-up and the trace's export).
            edges: list = []
            write_locked: list = []  # capture_lock held while the trace was written?
            DeviceTrace = _native.DeviceTrace  # noqa: N806 - the class patched here
            start, stop, write = DeviceTrace.start, DeviceTrace.stop, DeviceTrace.write

            def counted_start(trace):
                start(trace)
                edges.append((time.time(), counter.launch_counts()))

            def counted_stop(trace):
                edges.append((time.time(), counter.launch_counts()))
                return stop(trace)

            def watched_write(trace, *args):
                write_locked.append(capture_lock.locked())
                return write(trace, *args)

            DeviceTrace.start, DeviceTrace.stop = counted_start, counted_stop
            DeviceTrace.write = watched_write
            try:
                status, prof, _ = _http_json(server.port,
                                             f"/debug/profile?seconds={OBS_PROFILE_S}")
                t_reply = time.time()  # the trace exported and summarised
            finally:
                DeviceTrace.start, DeviceTrace.stop, DeviceTrace.write = start, stop, write
            if len(edges) != 2:
                _fail(f"observability: the recording started and stopped {len(edges)} times")
            if write_locked != [False]:
                _fail(f"observability: capture_lock held while the trace was written "
                      f"({write_locked})")
            (t_profile, launches0), (t_done, launches1) = edges
            _, err = proc.communicate(timeout=120)
            if proc.returncode != 0:
                _fail(f"observability: the profiled load exited {proc.returncode}: {err[-2000:]}")
            with np.load(os.path.join(root, "profiled.npz")) as z:
                res = {k: z[k] for k in z.files}
            if status != 200:
                _fail(f"observability: /debug/profile answered {status}: {prof}")
            with open(os.path.join(prof["trace_dir"], "trace.json")) as f:
                events = len(json.load(f)["traceEvents"])
            forwards = (launches1["fused_sepconv_block"] - launches0["fused_sepconv_block"]) \
                / per_forward["fused_sepconv_block"]
            stage = sum(v["count"] for k, v in prof["kernels"].items()
                        if "sepconv_stage_kernel" in k)
            if not stage or abs(stage - OBS_STAGE_LAUNCHES * forwards) > OBS_EDGE_LAUNCHES:
                _fail(f"observability: the profile counted {stage} sepconv_stage_kernel launches "
                      f"for {forwards} credited forwards (x{OBS_STAGE_LAUNCHES}, +-"
                      f"{OBS_EDGE_LAUNCHES}): {list(prof['kernels'])[:5]}")
            sent = res["status"] != 0
            if (res["status"][sent] != 200).any():
                _fail(f"observability: the profiled load saw {sorted(set(res['status'][sent]))}")
            # During the capture: from the profiler's start to the reply,
            # whose export of the trace holds the interpreter lock too.
            inside = sent & (res["done_at"] >= t_profile) & (res["sent_at"] <= t_reply)
            outside = sent & ~inside
            top = list(prof["kernels"].items())[:10]
            # Where the capture's stall fell: the slowest requests (send and
            # reply offsets from the profiler's start) and the longest span
            # with no reply at all.
            worst = np.argsort(-np.where(sent, res["lat_ms"], -1))[:5]
            done = np.sort(res["done_at"][sent])
            gap = int(np.argmax(np.diff(done))) if len(done) > 1 else 0
            out["profile_stall"] = dict(
                stop_edge_s=t_done - t_profile, reply_s=t_reply - t_profile,
                slowest=[[round(float(res["sent_at"][i] - t_profile), 3),
                          round(float(res["done_at"][i] - t_profile), 3),
                          round(float(res["lat_ms"][i]), 1)] for i in worst],
                longest_no_reply_ms=float(np.diff(done).max() * 1e3) if len(done) > 1 else 0.0,
                longest_no_reply_from_s=float(done[gap] - t_profile) if len(done) else 0.0)
            print("observability-stall:", json.dumps({**out["profile_stall"], "card": smi}),
                  flush=True)
            out["profile"] = dict(
                seconds=OBS_PROFILE_S, export_s=t_reply - t_done, trace_events=events,
                forwards=forwards,
                stage_kernel_launches=stage, per_forward=stage / max(forwards, 1),
                top10_device_ops=[{"name": k[:120], **v} for k, v in top],
                p99_ms_during_capture=float(np.percentile(res["lat_ms"][inside], 99)),
                p99_ms_outside_capture=float(np.percentile(res["lat_ms"][outside], 99)),
                requests_during=int(inside.sum()), requests_outside=int(outside.sum()))
            print("observability-profile:", json.dumps({**out["profile"], "card": smi}),
                  flush=True)
            ratio = out["profile"]["p99_ms_during_capture"] / out["profile"][
                "p99_ms_outside_capture"]
            if ratio > OBS_PROFILE_P99_RATIO:  # ROADMAP C5's gate
                _fail(f"observability: p99 during the capture is {ratio:.2f}x the p99 outside "
                      f"it (at most {OBS_PROFILE_P99_RATIO}x)")

            # --- a declared stall: one incident bundle, deduplicated ---
            server.dispatcher.declare_stall()
            body = protocol.encode_predict_request(images[:1])
            for rid in ("obs-stall-1", "obs-stall-2"):
                status, reply, headers = _http_json(
                    server.port, path, body, {"Content-Type": protocol.MSGPACK_CONTENT_TYPE,
                                              "X-Request-Id": rid})
                if status != 503 or headers.get("X-Kdlt-Stalled") != "1":
                    _fail(f"observability: stalled request {rid}: {status} {headers}")
                if not server.recorder.wait_idle(30.0):
                    _fail("observability: the incident capture did not finish")
            incidents = _http_json(server.port, "/debug/incidents")[1]["incidents"]
            bundle = (_http_json(server.port, f"/debug/incidents/{incidents[0]['id']}")[1]
                      if len(incidents) == 1 else {})
            if (len(incidents) != 1 or bundle["event"]["kind"] != "dispatch.stall"
                    or bundle["event"].get("rid") != "obs-stall-1"
                    or "obs-stall-1" not in bundle["traces"]):
                _fail(f"observability: incidents {incidents}")
            out["incident"] = dict(bundles=len(incidents), trigger=incidents[0]["trigger"],
                                   pinned_traces=sorted(bundle["traces"]),
                                   capture_latency_s=incidents[0]["capture_latency_s"])
        finally:
            server.shutdown()
    out["accounting_us_per_request"] = _accounting_cost_us(OBS_COST_REQUESTS)
    out["batching_depth2_img_s"] = depth2_img_s
    out["depth2_img_s_before_layer"] = DEPTH2_IMG_S_BEFORE
    return out


def _png_bytes(img: np.ndarray) -> bytes:
    """An RGB uint8 image as a PNG: filter 0 on every row, one zlib IDAT."""
    import struct
    import zlib

    h, w, _ = img.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _grid_png(seed: int) -> bytes:
    """A colour grid of GW_GRID_CELL-pixel cells, its colours from ``seed``."""
    h, w = GW_GRID_HW
    cells = np.random.default_rng(seed).integers(
        0, 256, (h // GW_GRID_CELL + 1, w // GW_GRID_CELL + 1, 3), dtype=np.uint8)
    return _png_bytes(np.repeat(np.repeat(cells, GW_GRID_CELL, 0), GW_GRID_CELL, 1)[:h, :w])


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gw_post(port: int, body: dict, headers: dict | None = None) -> tuple[int, bytes, dict]:
    """(status, raw body, headers) of one gateway ``POST /predict``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _gateway_phase(spec, seed: int, smi: str, *, counter, per_forward: dict) -> dict:
    """``POST /predict {"url"}`` through the port's gateway (ROADMAP A13,
    A6h): ``spec`` (clothing-model, K1 and K2) on a model server in this
    process (buckets 1-32, depth 2, the scheduler's lane), two gateways as
    processes of their own (``python -m ...serving.gateway``, the
    ``kdlt-torch-gateway`` entry point): the bytes wire (default) and the
    tensor wire (``KDLT_INGEST=0``).  Checks: the committed fixtures decode
    here (no PIL) to the pixels PIL gave; every checked image's reply, one
    request at a time, has the 10 labels and scores bit-equal to the tensor
    wire's straight to the server for the same locally decoded pixels, on
    both wires (among them progressive, CMYK and 16-bit Adam7 fixtures,
    held to PIL's digests first); 8 K1 and 2 K2 launches a forward; the bytes wire carried
    the bytes gateway's requests and the server decoded them; a repeated
    URL is a cache hit with the same body and no forward; an unsupported
    image is a JSON 400.  Then GW_TRACED traced requests a wire (span
    medians: fetch, decode, resize, upstream, the server's decode) and,
    for 16 and 32 closed-loop clients, img/s, p50 and p99 through each
    gateway against the same clients on the tensor wire direct."""
    import shutil

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import preprocess
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    name, hw = spec.name, spec.input_shape[:2]
    out: dict = {"model": name, "card": smi}
    procs: list = []
    with tempfile.TemporaryDirectory() as root:
        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir)
        # --- the fixtures: this machine's decode against PIL's pixels ---
        fixtures = sorted(f for f in os.listdir(GW_FIXTURES) if not f.endswith(".npy")
                          and os.path.isfile(os.path.join(GW_FIXTURES, f)))
        for f in fixtures:
            with open(os.path.join(GW_FIXTURES, f), "rb") as fh:
                got = preprocess.decode_image(fh.read())
            want = np.load(os.path.join(GW_FIXTURES, f + ".npy"))
            if got.shape != want.shape or not np.array_equal(got, want):
                _fail(f"gateway: fixture {f} decodes to other pixels than PIL's")
            shutil.copy(os.path.join(GW_FIXTURES, f), img_dir)
        digests = _format_digests()
        for f in GW_FORMAT_FIXTURES:  # progressive, CMYK, 16-bit Adam7: PIL's digests
            with open(os.path.join(FORMATS_DIR, f), "rb") as fh:
                got = preprocess.decode_image(fh.read())
            if (list(got.shape) != digests[f]["shape"]
                    or hashlib.sha256(got.tobytes()).hexdigest() != digests[f]["sha256"]):
                _fail(f"gateway: fixture {f} decodes to other pixels than PIL's")
            shutil.copy(os.path.join(FORMATS_DIR, f), img_dir)
        fixtures += GW_FORMAT_FIXTURES
        out["fixtures_equal_to_pil"] = fixtures
        files: dict[str, list[str]] = {"check": [], "traced-bytes": [], "traced-tensor": [],
                                       "load0": [], "load1": []}
        t0 = time.perf_counter()
        for group, count, base in (("check", GW_CHECK_GRIDS, 1000), ("traced-bytes", GW_TRACED,
                                   2000), ("traced-tensor", GW_TRACED, 3000),
                                   ("load0", GW_IMAGES, 10_000), ("load1", GW_IMAGES, 20_000)):
            for i in range(count):
                fname = f"{group}-{i}.png"
                with open(os.path.join(img_dir, fname), "wb") as fh:
                    fh.write(_grid_png(seed + base + i))
                files[group].append(fname)
        with open(os.path.join(img_dir, "bad.gif"), "wb") as fh:
            fh.write(b"GIF89a" + bytes(64))
        out["images_written_s"] = time.perf_counter() - t0
        img_port = _free_port()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", GW_IMAGE_SERVER, str(img_port), img_dir],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))

        def img_url(fname: str) -> str:
            return f"http://127.0.0.1:{img_port}/{fname}"

        art.save_artifact(art.version_dir(os.path.join(root, "models"), name, 1), spec,
                          init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"})
        server = ModelServer(os.path.join(root, "models"), port=0, buckets=BATCH_BUCKETS,
                             device="cuda", profile_base=None)
        server_url = f"http://127.0.0.1:{server.port}/v1/models/{name}:predict"
        try:
            server.start()
            server.warmup()
            gws: dict[str, int] = {}
            for wire, env in (("bytes", {}), ("tensor", {"KDLT_INGEST": "0"})):
                port = _free_port()
                log = open(os.path.join(root, f"gateway-{wire}.log"), "w")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.gateway",
                     "--serving-host", f"127.0.0.1:{server.port}", "--model", name,
                     "--port", str(port), "--no-request-log"],
                    env={**os.environ, **env}, stdout=log, stderr=subprocess.STDOUT,
                    cwd=os.path.dirname(os.path.abspath(__file__))))
                gws[wire] = port
            deadline = time.monotonic() + 120
            for wire, port in gws.items():
                while True:
                    try:
                        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                                    timeout=5) as r:
                            if r.status == 200:
                                break
                    except OSError:
                        pass
                    if time.monotonic() > deadline:
                        with open(os.path.join(root, f"gateway-{wire}.log")) as fh:
                            _fail(f"gateway: the {wire} gateway is not ready: {fh.read()[-2000:]}")
                    time.sleep(0.1)

            def batches() -> float:
                return _model_value(server, "kdlt_engine_batches_total", name)

            def check_launches(what: str, forwards: int) -> dict:
                launches = counter.launch_counts()
                want = {k: per_forward.get(k, 0) * forwards for k in launches}
                if launches != want or not forwards:
                    _fail(f"gateway {what}: launches {launches} != {want} for {forwards} forwards")
                return launches

            # --- one request at a time: bit-equal to the tensor wire direct ---
            counter.reset_launch_counts()
            b0 = batches()
            checked = [*fixtures, *files["check"]]
            replies: dict = {}
            for fname in checked:
                with open(os.path.join(img_dir, fname), "rb") as fh:
                    pixels = preprocess.resize_uint8(preprocess.decode_image(fh.read()), hw,
                                                     spec.resize_filter)
                direct = _post(server_url, pixels[None], "msgpack")[0][0]
                want = dict(zip(spec.labels, map(float, direct)))
                for wire, port in gws.items():
                    status, body, headers = _gw_post(port, {"url": img_url(fname)})
                    scores = json.loads(body) if status == 200 else body
                    if (status != 200 or list(scores) != list(spec.labels) or scores != want
                            or not np.isfinite(list(scores.values())).all()):
                        _fail(f"gateway {wire}: {fname}: {status} {str(scores)[:300]} != the "
                              f"tensor wire's {want}")
                    replies[(wire, fname)] = body
            forwards = int(batches() - b0)
            out["checked"] = dict(images=len(checked), wires=list(gws), bit_equal=True,
                                  forwards=forwards,
                                  launches=check_launches("checks", forwards))
            # --- the wires really used ---
            metrics = {w: urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics",
                                                 timeout=30).read().decode()
                       for w, p in gws.items()}

            def sample(text: str, series: str) -> float:
                found = re.search(rf"^{series} (\S+)$", text, re.M)
                return float(found.group(1)) if found else 0.0

            wire_use = dict(
                bytes_gateway_bytes_requests=sample(metrics["bytes"],
                                                    "kdlt_ingest_bytes_requests_total"),
                tensor_gateway_bytes_requests=sample(metrics["tensor"],
                                                     "kdlt_ingest_bytes_requests_total"),
                server_decoded_images=sample(server.registry.render(),
                                             "kdlt_ingest_decoded_images_total"))
            if (wire_use["bytes_gateway_bytes_requests"] != len(checked)
                    or wire_use["tensor_gateway_bytes_requests"]
                    or wire_use["server_decoded_images"] != len(checked)):
                _fail(f"gateway: the wires were not the ones asked for: {wire_use}")
            out["wire_use"] = wire_use
            # --- a repeated URL: a cache hit, the same body, no forward ---
            b0 = batches()
            for wire, port in gws.items():
                status, body, headers = _gw_post(port, {"url": img_url(checked[0])})
                if (status != 200 or headers.get("X-Kdlt-Cache") != "hit"
                        or body != replies[(wire, checked[0])]):
                    _fail(f"gateway {wire}: a repeated URL: {status} "
                          f"{headers.get('X-Kdlt-Cache')} (same body: "
                          f"{body == replies[(wire, checked[0])]})")
            if batches() != b0:
                _fail("gateway: a cache hit reached the model server")
            # --- an unsupported image: a JSON 400 ---
            for wire, port in gws.items():
                status, body, _ = _gw_post(port, {"url": img_url("bad.gif")})
                if status != 400 or "only JPEG and PNG" not in json.loads(body).get("error", ""):
                    _fail(f"gateway {wire}: a GIF answered {status} {body[:200]}")
            out["cache_hit_same_body"], out["unsupported_is_400"] = True, True

            # --- traced requests: where a request's time goes ---
            spans: dict = {}
            for wire, port in gws.items():
                rows = []
                for i, fname in enumerate(files[f"traced-{wire}"]):
                    rid = f"gw-{wire}-{i}"
                    status, body, _ = _gw_post(port, {"url": img_url(fname)},
                                               {"X-Request-Id": rid})
                    if status != 200:
                        _fail(f"gateway {wire}: traced request {rid}: {status} {body[:200]}")
                    deadline = time.monotonic() + 10
                    while True:  # the root span closes just after the reply
                        status, info, _ = _http_json(port, f"/debug/trace/{rid}")
                        names = [sp["name"] for sp in info.get("spans", [])]
                        if status == 200 and "gateway.request" in names \
                                and "server.request" in names:
                            break
                        if time.monotonic() > deadline:
                            _fail(f"gateway {wire}: trace {rid}: {status} {names}")
                        time.sleep(0.01)
                    by = {}
                    for sp in info["spans"]:
                        by.setdefault(sp["name"], sp)
                    tags = by["gateway.preprocess"]["tags"]
                    rows.append(dict(
                        fetch_ms=tags["fetch_ms"], decode_ms=tags.get("decode_ms"),
                        resize_ms=tags.get("resize_ms"),
                        upstream_ms=by["gateway.upstream"]["dur_ms"],
                        server_ingest_decode_ms=by.get("server.ingest_decode",
                                                       {}).get("dur_ms"),
                        server_request_ms=by["server.request"]["dur_ms"],
                        gateway_request_ms=by["gateway.request"]["dur_ms"]))
                spans[wire] = {k: (float(np.median([r[k] for r in rows]))
                                   if rows[0][k] is not None else None) for k in rows[0]}
                print("gateway-spans:", json.dumps({"wire": wire, "requests": len(rows),
                                                    "median_ms": spans[wire], "card": smi}),
                      flush=True)
            out["span_median_ms"] = spans

            # --- load: 16 and 32 closed-loop clients, gateway against direct ---
            loads = []
            for s, clients in enumerate(GW_CLIENTS):
                group = files[f"load{s}"]
                urls_path = os.path.join(root, f"urls{s}.txt")
                with open(urls_path, "w") as fh:
                    fh.write("\n".join(img_url(f) for f in group))
                pixels = []
                for fname in group:
                    with open(os.path.join(img_dir, fname), "rb") as fh:
                        pixels.append(preprocess.resize_uint8(
                            preprocess.decode_image(fh.read()), hw, spec.resize_filter))
                npy = os.path.join(root, f"pixels{s}.npy")
                np.save(npy, np.stack(pixels))
                per_client = GW_IMAGES // clients
                for path in ("gateway-bytes", "gateway-tensor", "direct"):
                    out_path = os.path.join(root, f"{path}-{clients}.npz")
                    if path == "direct":
                        args = (server_url, npy, out_path, 600, "--clients", clients,
                                "--requests", per_client)
                    else:
                        args = (f"http://127.0.0.1:{gws[path.split('-')[1]]}/predict", None,
                                out_path, 600, "--clients", clients, "--requests", per_client,
                                "--image-urls", urls_path)
                    counter.reset_launch_counts()
                    b0 = batches()
                    res = _load_run(*args)
                    forwards = int(batches() - b0)
                    launches = check_launches(f"{path} load", forwards)
                    logits = res["logits"]
                    if ((res["status"] != 200).any() or logits.shape[1] != len(spec.labels)
                            or not np.isfinite(logits).all()):
                        _fail(f"gateway {path} x{clients}: statuses "
                              f"{sorted(set(res['status'].tolist()))}, logits {logits.shape}")
                    lat, n = res["lat_ms"], len(res["lat_ms"])
                    loads.append(dict(path=path, clients=clients, requests=n,
                                      img_per_s=n / float(res["wall_s"]),
                                      p50_ms=float(np.percentile(lat, 50)),
                                      p99_ms=float(np.percentile(lat, 99)), forwards=forwards,
                                      mean_batch=n / max(forwards, 1), launches=launches))
                    print("gateway-load:", json.dumps({**loads[-1], "card": smi}), flush=True)
            out["load"] = loads
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            server.shutdown()
    return out


def _format_digests() -> dict:
    with open(os.path.join(FORMATS_DIR, "digests.json")) as fh:
        return json.load(fh)


def _ingest_formats_phase(smi: str) -> dict:
    """The decoder's breadth on this machine's host (no PIL here): every
    fixture of ``tests/ingest_fixtures/formats`` must decode to the shape
    and pixel digest PIL gave.  Then the host ms per megapixel of the
    800x600 photo decoded from its progressive and its baseline file (the
    same pixels), and of every large fixture, each the median of
    FORMAT_DECODE_REPS decodes taken in turns (the order reversed every
    round: the host's speed drifts)."""
    from kubernetes_deep_learning_tpu_torch.ops import preprocess

    digests = _format_digests()
    counts: dict[str, int] = {}
    for name, entry in sorted(digests.items()):
        with open(os.path.join(FORMATS_DIR, name), "rb") as fh:
            got = preprocess.decode_image(fh.read())
        if (list(got.shape) != entry["shape"]
                or hashlib.sha256(got.tobytes()).hexdigest() != entry["sha256"]):
            _fail(f"ingest-formats: {name} ({entry['format']}) decodes to {got.shape}, not to "
                  f"PIL's {entry['shape']} pixels")
        counts[entry["format"]] = counts.get(entry["format"], 0) + 1
    large = {}
    for name in sorted(n for n, e in digests.items() if e["format"] == "large"):
        with open(os.path.join(FORMATS_DIR, name), "rb") as fh:
            large[name] = fh.read()
        preprocess.decode_image(large[name])
    times: dict[str, list[float]] = {n: [] for n in large}
    for r in range(FORMAT_DECODE_REPS):
        for name in (sorted(large) if r % 2 == 0 else sorted(large, reverse=True)):
            t0 = time.perf_counter()
            preprocess.decode_image(large[name])
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms_per_mp = {n: float(np.median(times[n])) / (digests[n]["shape"][0] * digests[n]["shape"][1]
                                                 / 1e6) for n in large}
    out = dict(fixtures=len(digests), equal_to_pil_digest=len(digests), per_format=counts,
               host_decode_ms_per_mp=ms_per_mp,
               progressive_ms_per_mp=ms_per_mp["large_800x600_prog.jpg"],
               baseline_ms_per_mp=ms_per_mp["large_800x600.jpg"],
               progressive_over_baseline=(ms_per_mp["large_800x600_prog.jpg"]
                                          / ms_per_mp["large_800x600.jpg"]),
               host_cores=len(os.sched_getaffinity(0)), card=smi)
    return out


def _photo_png(h: int, w: int, seed: int) -> bytes:
    """A smooth photo-like RGB PNG (blurred blobs and noise) from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for _ in range(12):
        cy, cx, r = rng.random(), rng.random(), 0.05 + 0.3 * rng.random()
        img += rng.random(3) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / r**2)[..., None]
    img = img / img.max() * 255 + rng.normal(0, 2, (h, w, 3))
    return _png_bytes(np.clip(img, 0, 255).astype(np.uint8))


def _staged_trace(staged, plain, seed: int) -> dict:
    """One traced replay of the staged engine's largest bucket graph and one
    of the plain engine's, each the second of two replays with a spin
    between (as ``_trace_check``): the staged one must launch the plain
    one's kernels plus the resize's (the kernels it has beyond them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed)
    b = staged.max_batch
    imgs = {"staged": rng.integers(0, 256, (b, *staged.ingest_source_shape), np.uint8),
            "plain": rng.integers(0, 256, (b, *plain.spec.input_shape), np.uint8)}
    run = {"staged": lambda: np.asarray(staged.predict_ingest_async(imgs["staged"])[0]),
           "plain": lambda: np.asarray(plain.predict_async(imgs["plain"])[0])}
    names = {}
    for route, fn in run.items():
        fn()
        # torch.profiler can drop the records of a window's end in a
        # process that traced before (the plain route's window has kept 23
        # of its ~157 records, its D2H copy not among them): a window
        # without the replay's readback is retaken.
        for _ in range(TRACE_ATTEMPTS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda._sleep(TRACE_MARK_CYCLES)
                torch.cuda.synchronize()
                fn()
            events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            marks = [e.time_range.end for e in events if "spin_kernel" in e.name]
            if not marks:
                _fail(f"device-resize: the {route} trace holds no spin kernel")
            names[route] = [e.name for e in events if e.time_range.start >= max(marks)]
            if any("Memcpy DtoH" in n for n in names[route]):
                break
        else:
            _fail(f"device-resize: {TRACE_ATTEMPTS} traces of the {route} route lost their "
                  f"readback: {len(names[route])} records after the mark")
    count = lambda ns, key: sum(key in n for n in ns)  # noqa: E731
    stage = {r: count(ns, "sepconv_stage_kernel") for r, ns in names.items()}
    extra: dict[str, int] = {}
    rest = list(names["plain"])
    for n in names["staged"]:
        if n in rest:
            rest.remove(n)
        else:
            extra[n[:120]] = extra.get(n[:120], 0) + 1
    return dict(bucket=b, stage_kernels=stage, resize_kernels=extra,
                resize_products=sum(v for k, v in extra.items()
                                    if any(w in k.lower() for w in ("gemm", "xmma", "cutlass"))),
                records=dict(staged=len(names["staged"]), plain=len(names["plain"])))


def _device_resize_phase(spec, seed: int, smi: str, *, counter, per_forward: dict) -> dict:
    """Device-resize staging (ROADMAP A13b) on ``spec`` (clothing-model,
    nearest): two servers of the same artifact, the default route (the
    bytes wire decodes and resizes to 299 on the host) and the staged one
    (``KDLT_INGEST_DEVICE_RESIZE`` = DR_STAGING: the host decodes and
    resizes to 512x512, the engine's staged graph resizes to 299 on the
    card).  The large fixtures and DR_EXTRA generated PNGs, one request an
    image and one of 16, on the bytes wire of both: the staged replies must
    equal the staged engine's own dispatch of the locally staged pixels
    bit for bit, the staged graphs must replay their eager form (bit-equal
    or within GRAPH_TOL), and every staged chunk must launch 8 K1 and 2 K2;
    top-1 agreement and the max abs logit difference against the default
    route are reported.  Then a traced replay of each route's bucket-16
    graph (the staged one: K1/K2 and the resize's kernels), the same for a
    linear-resize variant of the model (the resize as two float32
    products), the resize's device ms per method, p50 at buckets 1/4/16 of
    each route's dispatch in turns, and the host decode ms per image at
    512x512 against 299."""
    import dataclasses

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import preprocess
    from kubernetes_deep_learning_tpu_torch.ops import resize as resize_lib
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
    from kubernetes_deep_learning_tpu_torch.serving import protocol
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    name, hw = spec.name, tuple(spec.input_shape[:2])
    sh, sw = map(int, DR_STAGING.split("x"))
    out: dict = {"model": name, "staging": DR_STAGING, "resize": spec.resize_filter, "card": smi}
    digests = _format_digests()
    blobs = {}
    for f in sorted(n for n, e in digests.items() if e["format"] == "large"):
        with open(os.path.join(FORMATS_DIR, f), "rb") as fh:
            blobs[f] = fh.read()
    for i in range(DR_EXTRA):
        h, w = DR_EXTRA_HW[i % len(DR_EXTRA_HW)]
        blobs[f"photo-{h}x{w}-{i}.png"] = _photo_png(h, w, seed + 500 + i)
    names = list(blobs)
    # Host decode: at the staging size against at the model's size.
    host = {}
    for size in ((sh, sw), hw):
        preprocess.preprocess_bytes(blobs[names[0]], size, filter=spec.resize_filter)
        per = []
        for n in names:
            t0 = time.perf_counter()
            preprocess.preprocess_bytes(blobs[n], size, filter=spec.resize_filter)
            per.append((time.perf_counter() - t0) * 1e3)
        host[f"{size[0]}x{size[1]}"] = float(np.median(per))
    out["host_decode_ms_per_image"] = host
    staged_px = np.stack([preprocess.preprocess_bytes(blobs[n], (sh, sw),
                                                      filter=spec.resize_filter) for n in names])
    with tempfile.TemporaryDirectory() as root:
        art.save_artifact(art.version_dir(root, name, 1), spec, init_variables(spec, seed=seed),
                          {"compute_dtype": "bfloat16"})
        servers = {
            "default": ModelServer(root, port=0, buckets=DR_BUCKETS, device="cuda",
                                   profile_base=None),
            "staged": ModelServer(root, port=0, buckets=DR_BUCKETS, device="cuda",
                                  profile_base=None, engine_factory=lambda a, **kw:
                                  InferenceEngine(a, ingest_resize=DR_STAGING, **kw))}
        linear = None
        try:
            torch.cuda.synchronize()
            allocated = {"before": torch.cuda.memory_allocated()}
            for route, server in servers.items():
                server.start()
                server.warmup()
                torch.cuda.synchronize()
                allocated[route] = torch.cuda.memory_allocated()
            out["allocated_by_server_bytes"] = {
                "default": allocated["default"] - allocated["before"],
                "staged": allocated["staged"] - allocated["default"]}
            engines = {r: s.models[name].engine for r, s in servers.items()}
            if (engines["staged"].ingest_source_shape != (sh, sw, 3)
                    or sorted(engines["staged"]._staged_graphs) != list(DR_BUCKETS)
                    or engines["default"]._staged_graphs
                    or engines["default"]._resize is not None):
                _fail("device-resize: the staged engine's graphs or the default engine's "
                      "absence of them are not as configured")
            # --- the bytes wire on both routes ---
            replies: dict = {r: {} for r in servers}
            requests = [[n] for n in names] + [names[:16]]
            counter.reset_launch_counts()
            for route, server in servers.items():
                url = f"http://127.0.0.1:{server.port}/v1/models/{name}:predict"
                for group in requests:
                    body = protocol.encode_bytes_predict_request([blobs[n] for n in group])
                    req = urllib.request.Request(url, data=body, method="POST", headers={
                        "Content-Type": protocol.BYTES_CONTENT_TYPE})
                    with urllib.request.urlopen(req, timeout=120) as r:
                        status, payload = r.status, json.loads(r.read())
                    logits = np.array([[row[k] for k in spec.labels]
                                       for row in payload["predictions"]], np.float32)
                    if status != 200 or logits.shape != (len(group), len(spec.labels)) \
                            or not np.isfinite(logits).all():
                        _fail(f"device-resize {route}: {group[:2]}...: {status} {logits.shape}")
                    for n, row in zip(group, logits):
                        replies[route].setdefault(n, []).append(row)
                if route == "default":  # the staged route's launches alone below
                    counter.reset_launch_counts()
            launches = counter.launch_counts()
            want = {k: per_forward.get(k, 0) * len(requests) for k in launches}
            if launches != want:
                _fail(f"device-resize: staged launches {launches} != {want} for "
                      f"{len(requests)} staged chunks")
            # The staged replies against the engine's own dispatch of the
            # same staged pixels (one request a chunk, as the server sent).
            eng = engines["staged"]
            for i, n in enumerate(names):
                direct = np.asarray(eng.predict_ingest_async(staged_px[i:i + 1])[0])[0]
                if any(not np.array_equal(row, direct) for row in replies["staged"][n][:1]):
                    _fail(f"device-resize: the staged reply for {n} is not the engine's")
            default = np.stack([replies["default"][n][0] for n in names])
            staged = np.stack([replies["staged"][n][0] for n in names])
            batched = np.stack([replies["staged"][n][-1] for n in names[:16]])
            out["bytes_wire"] = dict(
                images=len(names), requests=len(requests), launches=launches,
                staged_equal_engine=True,
                top1_agreement=float((staged.argmax(1) == default.argmax(1)).mean()),
                max_abs_logit_diff=float(np.abs(staged - default).max()),
                logit_scale=float(np.abs(default).max()),
                bucket16_vs_single_max_abs=float(np.abs(batched - staged[:16]).max()))
            # --- the staged graphs against their eager form ---
            graph = {}
            rng = np.random.default_rng(seed + 7)
            for b in DR_BUCKETS:
                x = rng.integers(0, 256, (b, sh, sw, 3), np.uint8)
                rows = np.asarray(eng.predict_ingest_async(x)[0]).copy()
                with torch.inference_mode():
                    ref = eng._staged_forward(torch.from_numpy(x).cuda()).float().cpu().numpy()
                rel = float(np.abs(rows - ref).max() / (np.abs(ref).max() + 1e-6))
                if not np.isfinite(rows).all() or rel > GRAPH_TOL:
                    _fail(f"device-resize: bucket {b}'s staged graph vs eager: {rel:.3e}")
                graph[str(b)] = dict(bit_equal=bool(np.array_equal(rows, ref)), rel=rel)
            out["staged_graph_vs_eager"] = graph
            # --- traced replays: K1/K2 and the resize's kernels ---
            trace = _staged_trace(eng, engines["default"], seed)
            if trace["stage_kernels"] != {"staged": 28, "plain": 28} or not trace["resize_kernels"]:
                _fail(f"device-resize: traced bucket-16 replays: {trace}")
            linear_spec = dataclasses.replace(spec, name=f"{name}-linear",
                                              resize_filter="bilinear")
            linear = InferenceEngine(
                art.ModelArtifact(linear_spec, init_variables(spec, seed=seed),
                                  {"compute_dtype": "bfloat16"}),
                buckets=(DR_BUCKETS[-1],), device="cuda", ingest_resize=DR_STAGING)
            linear.warmup()
            trace_linear = _staged_trace(linear, engines["default"], seed)
            if trace_linear["stage_kernels"] != {"staged": 28, "plain": 28} \
                    or trace_linear["resize_products"] < 2:
                _fail(f"device-resize: traced linear bucket-16 replays: {trace_linear}")
            out["trace"] = {"nearest": trace, "linear": trace_linear}
            print("device-resize-trace:", json.dumps({**out["trace"], "card": smi}), flush=True)
            # --- the resize alone: device ms by graph replay ---
            x16 = torch.from_numpy(rng.integers(0, 256, (16, sh, sw, 3), np.uint8)).cuda()
            resize_ms = {}
            for method in ("nearest", "linear"):
                rz = resize_lib.Resize((sh, sw), hw, method, "cuda")
                resize_ms[method] = _graph_ms(lambda: resize_lib.resize_to_uint8(rz, x16), ITERS)
            moved = 16 * 3 * (sh * sw + hw[0] * hw[1])  # uint8 in, uint8 out
            out["resize_device_ms_bucket16"] = resize_ms
            out["resize_bytes_bound_ms"] = moved / PEAK_BYTES * 1e3
            # --- p50 a bucket, staged against default, in turns ---
            p50 = {}
            for b in DR_BUCKETS:
                xs = rng.integers(0, 256, (b, sh, sw, 3), np.uint8)
                xd = rng.integers(0, 256, (b, *spec.input_shape), np.uint8)
                fns = {"staged": lambda: np.asarray(eng.predict_ingest_async(xs)[0]),
                       "default": lambda: np.asarray(engines["default"].predict_async(xd)[0])}
                lat = {r: [] for r in fns}
                for _ in range(2):
                    for fn in fns.values():
                        fn()
                for _ in range(DR_ITERS):
                    for r, fn in fns.items():
                        t0 = time.perf_counter()
                        fn()
                        lat[r].append((time.perf_counter() - t0) * 1e3)
                p50[str(b)] = {r: float(np.median(v)) for r, v in lat.items()}
            out["dispatch_p50_ms"] = p50
            out["graph_memory_bytes"] = {r: e.graph_memory_bytes() for r, e in engines.items()}
        finally:
            if linear is not None:
                linear.close()
            for server in servers.values():
                server.shutdown()
    return out


def _obs_load_args(seconds: float) -> tuple:
    """The observability phase's load: OBS_CLIENTS closed-loop clients for
    ``seconds``."""
    return ("--clients", OBS_CLIENTS, "--requests", 4000, "--duration", seconds)


def _dispatch_host_profile(engine, imgs: np.ndarray, steps: int = 5) -> None:
    """Host time by op of ``steps`` bucket-16 dispatches (``predict_async``,
    then the wait for its handle): where the dispatch stage's time goes.
    Beside each, the same batch's copy into a lent staging slot alone
    (``staging-copy``), the part of a dispatch that is the host copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    slot = engine.lend_staging()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            with record_function("dispatch"):
                handle, _ = engine.predict_async(imgs)
            with record_function("wait"):
                np.asarray(handle)
            with record_function("staging-copy"):
                slot.array[: len(imgs)] = imgs
    engine.return_staging(slot)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    rows.sort(key=lambda e: -e.self_cpu_time_total)
    totals = {e.key: e.cpu_time_total / 1e3 / steps for e in rows
              if e.key in ("dispatch", "wait", "staging-copy")}
    share = totals.get("staging-copy", 0.0) / totals["dispatch"] if totals.get("dispatch") else None
    print("batching-host:", json.dumps({"bucket": len(imgs), "ms_per_call": totals,
                                        "staging_copy_share_of_dispatch": share}), flush=True)
    for e in rows[:15]:
        print("batching-host-op:", json.dumps({
            "name": e.key[:90], "calls_per_dispatch": e.count / steps,
            "self_cpu_ms_per_dispatch": e.self_cpu_time_total / 1e3 / steps}), flush=True)


def _routing_phase(seed: int) -> dict:
    """The registered 256-px ViT-B/16 (256 tokens) on the card: the einsum
    route, so no K3 launch."""
    from kubernetes_deep_learning_tpu_torch.export.artifact import ModelArtifact
    from kubernetes_deep_learning_tpu_torch.modelspec import VIT_B16_IMAGENET as spec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.vit import VIT_CONFIGS
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    engine = InferenceEngine(
        ModelArtifact(spec, init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"}),
        buckets=(1,), device="cuda")
    engine.warmup()
    imgs = np.random.default_rng(seed + 2).integers(0, 256, (1, *spec.input_shape), np.uint8)
    attn.reset_launch_counts()
    logits = engine.predict(imgs)
    counts = attn.launch_counts()
    launches = counts["flash_attention"]
    if logits.shape != (1, spec.num_classes) or not np.isfinite(logits).all():
        _fail(f"{spec.name}: bad logits {logits.shape}")
    if any(counts.values()):
        _fail(f"{spec.name} (256 tokens) launched attention kernels {counts}, expected none")
    patch = VIT_CONFIGS[spec.family].patch
    return dict(model=spec.name, tokens=(spec.input_shape[0] // patch) ** 2,
                flash_attention_launches=launches)


def _partials_rel(got, want) -> tuple[float, float, int]:
    """(max abs error, max relative error over acc, m and l, rows without a
    visible key) on the rows with one; those rows must be exactly
    (0, NEG_INF, 0) in ``got``."""
    from kubernetes_deep_learning_tpu_torch.ops.attention import NEG_INF

    live = want[1] > NEG_INF * 0.5
    acc, m, l = (t[~live] for t in got)
    if acc.any() or l.any() or not bool((m == NEG_INF).all()):
        _fail("flash_attention_partials: a row without a visible key is not (0, NEG_INF, 0)")
    errs = [_rel(g[live], w[live]) for g, w in zip(got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs), int((~live).sum())


def _library_lse(q, k, v):
    """(out, logsumexp) from one aten attention op: the yardstick for K3P
    plus its finalisation, used nowhere in the port."""
    if q.dtype == torch.bfloat16:
        return torch.ops.aten._scaled_dot_product_flash_attention(q, k, v)[:2]
    return torch.ops.aten._scaled_dot_product_efficient_attention(q, k, v, None, True)[:2]


def _partials_phase(iters: int, gen: torch.Generator, exp_rate: float) -> dict:
    """K3P against its plain version; the record for the ``kernels`` line
    (times of the f32 form, ``fit``'s, with the bf16 form beside them)."""
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn

    bf16, f32 = torch.bfloat16, torch.float32
    main = (TRAIN_BATCH, 12, 256, 256, 64)  # ViT-B/16 at 256 px, the training batch
    cases = [  # (B, H, Sq, Sk, D), dtype, flash_attention keywords, timed
        (main, f32, {}, True),
        (main, bf16, {}, True),
        ((2, 3, 200, 330, 64), bf16, dict(causal=True, k_offset=-64), False),
        ((2, 3, 128, 128, 64), f32, dict(causal=True, k_offset=64), False),  # 64 rows see no key
        ((2, 3, 128, 128, 64), bf16, dict(causal=True, k_offset=64), False),
        ((1, 4, 300, 300, 32), bf16, dict(causal=True), False),
        ((1, 2, 257, 257, 128), bf16, dict(kv_len=200), False),
        ((1, 2, 250, 190, 32), f32, dict(kv_len=150), False),
        ((1, 2, 192, 192, 128), f32, dict(causal=True), False),
    ]
    rec = dict(name="flash_attention_partials", route="cuda",
               source=SOURCES["flash_attention_partials"],
               replaces="kubernetes_deep_learning_tpu/ops/attention.py:316",
               max_abs_err=0.0, max_rel_err=0.0, tol_rel=F32_KERNEL_TOL, bf16_tol_rel=KERNEL_TOL,
               per=f"one call at {main[:3] + main[4:]} f32 (fit's); errors: max over the "
                   "checked cases; bf16: the same call in bf16")
    for (b, h, sq, sk, d), dtype, kw, timed in cases:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        kernel = functools.partial(attn.flash_attention, q, k, v, return_partials=True, **kw)
        plain = functools.partial(attn.flash_attention_partials_reference, q, k, v, **kw)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        shape = dict(q=[b, h, sq, d], sk=sk, dtype=str(dtype).removeprefix("torch."), **kw)
        if not all(torch.isfinite(t).all() for t in got):
            _fail(f"flash_attention_partials {shape}: non-finite output")
        err, rel, dead = _partials_rel(got, want)
        tol = KERNEL_TOL if dtype == bf16 else F32_KERNEL_TOL
        if rel > tol:
            _fail(f"flash_attention_partials {shape}: relative error {rel:.3e} > {tol}")
        t = dict(shape, max_abs_err=err, max_rel_err=rel, tol_rel=tol, rows_without_key=dead)
        if timed:
            nbytes = (q.element_size() * b * h * d * (sq + 2 * sk)  # q, k, v
                      + 4 * b * h * sq * (d + 2))                   # acc, m, l in f32
            b_ms, b_by, terms = _attention_bound(b * h, sq, sk, d, nbytes, dtype, exp_rate)
            out, lse = attn._forward_with_lse(q, k, v, False)
            lib_out, lib_lse = _library_lse(q, k, v)
            t.update(ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     finalized_ms=_time_ms(lambda: attn._forward_with_lse(q, k, v, False), iters),
                     library_ms=_time_ms(lambda: _library_lse(q, k, v), iters),
                     graph_ms=_graph_ms(kernel, iters),
                     library_graph_ms=_graph_ms(lambda: _library_lse(q, k, v), iters),
                     library_vs_finalized_rel=max(_rel(out, lib_out)[1], _rel(lse, lib_lse)[1]),
                     bound_ms=b_ms, bound_by=b_by, bound_terms_ms=terms)
            keys = ("ms", "plain_ms", "finalized_ms", "library_ms", "graph_ms", "library_graph_ms",
                    "bound_ms", "bound_by")
            if dtype == f32:
                rec.update({key: t[key] for key in keys})
            else:
                rec["bf16"] = {key: t[key] for key in keys}
        print("kernel-check flash_attention_partials", json.dumps(t), flush=True)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    return rec


def _grads_phase(gen: torch.Generator, iters: int) -> dict:
    """attention_trainable (K3P forward, blockwise torch backward) against
    autograd through plain f32 attention at the training shape, given as
    (B, S, H, D) projections viewed as (B, H, S, D), as the ViT does; and
    the time of its forward and backward per block, f32 and bf16."""
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn

    b, s, h, d = TRAIN_BATCH, 256, 12, 64
    leaves = [torch.randn((b, s, h, d), generator=gen, device="cuda").requires_grad_()
              for _ in range(3)]
    cot = torch.randn((b, h, s, d), generator=gen, device="cuda")
    results = []
    for fn in (attn.attention_trainable, attn.mha_reference):
        out = fn(*(t.transpose(1, 2) for t in leaves))
        results.append((out.detach(), torch.autograd.grad((out * cot).sum(), leaves)))
    torch.cuda.synchronize()
    (out, grads), (want, want_grads) = results
    rel = {"out": _rel(out, want)[1]}
    rel.update({f"d{n}": _rel(g, w)[1] for n, g, w in zip("qkv", grads, want_grads)})
    for name, r in rel.items():
        if not r < F32_KERNEL_TOL:
            _fail(f"attention_trainable {name}: relative error {r:.3e} > {F32_KERNEL_TOL}")
    summary = dict(shape=[b, h, s, d], rel_err=rel, tol_rel=F32_KERNEL_TOL)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.detach().to(dtype).transpose(1, 2) for t in leaves)
        o, lse = attn._forward_with_lse(q, k, v, False)
        dout = cot.to(dtype)
        summary[str(dtype).removeprefix("torch.")] = dict(
            forward_ms=_time_ms(lambda: attn._forward_with_lse(q, k, v, False), iters),
            backward_ms=_time_ms(lambda: attn._attn_bwd(False, q, k, v, o, lse, dout), iters))
    return summary


def _train_batches(spec, seed: int):
    """One ``synthetic_batches`` batch of TRAIN_BATCH, repeated: the loss
    must fall on it."""
    from kubernetes_deep_learning_tpu_torch.training import synthetic_batches

    batch = next(synthetic_batches(spec, TRAIN_BATCH, seed=seed))
    return batch, (lambda n: itertools.repeat(batch, n))


def _training_phase(seed: int, profile: bool, grads: dict, smi: str) -> tuple[dict, dict]:
    """fit() on ViT-B/16 at 256 px, then checkpoint, resume, export and
    serve.  Returns (summary, K3P launches of the fit run)."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.modelspec import VIT_B16_IMAGENET as spec
    from kubernetes_deep_learning_tpu_torch.models import build_forward
    from kubernetes_deep_learning_tpu_torch.models.vit import VIT_CONFIGS
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine
    from kubernetes_deep_learning_tpu_torch.training import (
        Checkpointer,
        build_eval_step,
        build_train_step,
        create_train_state,
        fit,
        fit_and_export,
    )

    depth = VIT_CONFIGS[spec.family].depth
    tx = functools.partial(torch.optim.Adam, lr=TRAIN_LR, eps=1e-8)
    batch, repeat = _train_batches(spec, seed)
    state = create_train_state(spec, tx, seed=seed, device="cuda")

    # The eval step (train=False) at 256 tokens takes the einsum route.
    attn.reset_launch_counts()
    m = build_eval_step(spec)(state, *batch)
    eval_loss = float(m["loss_sum"]) / float(m["count"])
    if any(attn.launch_counts().values()):
        _fail(f"{spec.name} eval step launched attention kernels: {attn.launch_counts()}")

    summary = dict(model=spec.name, batch=TRAIN_BATCH, dtype="float32", optimizer="adam",
                   lr=TRAIN_LR, card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir, root = f"{tmp}/ckpt", f"{tmp}/models"
        logs: list[str] = []
        # --- the main path: fit() -> train_step -> attention_trainable -> K3P ---
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        attn.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = fit(spec, tx, repeat(TRAIN_STEPS), TRAIN_STEPS, state=state,
                          ckpt_dir=ckpt_dir, ckpt_every=TRAIN_STEPS // 2, log_every=1,
                          log_fn=logs.append, eval_batches=lambda: [batch])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = attn.launch_counts()
        want = {"flash_attention": 0, "flash_attention_partials": depth * TRAIN_STEPS,
                "flash_gfold": 0}
        if launches != want:
            _fail(f"{spec.name} fit: kernel launches {launches} != {want} for {TRAIN_STEPS} "
                  "steps and a final eval pass")
        losses = [loss for _, loss in hist]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            _fail(f"{spec.name} fit: losses {losses}")
        if not losses[-1] < losses[0]:
            _fail(f"{spec.name} fit: the loss did not fall: {losses}")
        first_rel = abs(losses[0] - eval_loss) / abs(eval_loss)
        if not first_rel < F32_KERNEL_TOL:
            _fail(f"{spec.name}: first train-step loss {losses[0]} vs eval-mode loss "
                  f"{eval_loss}: relative {first_rel:.3e} > {F32_KERNEL_TOL}")
        summary.update(steps=TRAIN_STEPS, fit_s=fit_s, losses=losses, eval_loss_step0=eval_loss,
                       first_step_vs_eval_rel=first_rel, launches=launches,
                       peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                       final_eval=[line for line in logs if line.startswith("eval")])

        # --- checkpoint: restore into a fresh state, resume, export, serve ---
        fresh = create_train_state(spec, tx, seed=seed + 1, device="cuda")
        with Checkpointer(ckpt_dir) as ckpt:
            restored = ckpt.restore(fresh)
        if restored is None or fresh.step != TRAIN_STEPS:
            _fail(f"checkpoint restore: step {fresh.step}, expected {TRAIN_STEPS}")
        if not all(torch.equal(fresh.params[k], t) for k, t in state.params.items()):
            _fail("checkpoint restore: parameters differ from the trained state's")
        logs.clear()
        fresh, _ = fit(spec, tx, repeat(2), TRAIN_STEPS + 2, state=fresh, ckpt_dir=ckpt_dir,
                       log_fn=logs.append)
        if fresh.step != TRAIN_STEPS + 2 or not any("resumed" in x for x in logs):
            _fail(f"resume: step {fresh.step}, log {logs}")
        del fresh
        d = fit_and_export(spec, tx, repeat(0), TRAIN_STEPS + 2, root, ckpt_dir=ckpt_dir,
                           seed=seed + 2, log_fn=logs.append)
        resumed = create_train_state(spec, tx, seed=seed + 3, device="cuda")
        with Checkpointer(ckpt_dir) as ckpt:
            ckpt.restore(resumed)
            ckpt_steps = ckpt.all_steps()
        params = {k: t.detach() for k, t in resumed.params.items()}
        del resumed
        engine = InferenceEngine(art.load_artifact(d), buckets=(8,), device="cuda")
        imgs = np.random.default_rng(seed + 3).integers(0, 256, (8, *spec.input_shape),
                                                         np.uint8)
        served = {}
        with torch.inference_mode():
            for dtype, x in ((torch.bfloat16, imgs),
                             (torch.float32, (imgs / 127.5 - 1.0).astype(np.float32))):
                want_logits = build_forward(spec, params, dtype, "auto", "cuda")(
                    torch.from_numpy(x).cuda()).cpu().numpy()
                got = engine.predict(x)
                if got.shape != (8, spec.num_classes) or not np.isfinite(got).all():
                    _fail(f"served trained artifact: bad logits {got.shape}")
                rel = float(np.abs(got - want_logits).max() / (np.abs(want_logits).max() + 1e-6))
                if not rel < F32_KERNEL_TOL:
                    _fail(f"served trained artifact ({dtype}): relative {rel:.3e} against the "
                          "trained parameters' eval forward")
                served[str(dtype).removeprefix("torch.")] = rel
        del engine, params
        summary.update(checkpoint_steps=ckpt_steps,
                       resumed_to=TRAIN_STEPS + 2, exported=d.removeprefix(tmp),
                       served_vs_eval_forward_rel=served)

    # --- step time: further f32 steps, each synced; then bf16 steps ---
    step = build_train_step(spec)
    batch = tuple(torch.as_tensor(a, device="cuda") for a in batch)  # time the step, not the H2D
    lat = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, *batch)
        float(m["loss"])
        lat.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(lat))
    summary.update(step_ms=lat, step_ms_p50=p50, img_per_s=TRAIN_BATCH / (p50 / 1e3))
    k3p_ms = depth * grads["float32"]["forward_ms"]
    bwd_ms = depth * grads["float32"]["backward_ms"]
    summary.update(k3p_share_of_step=k3p_ms / p50, attention_backward_share_of_step=bwd_ms / p50)
    if profile:
        _profile(f"{spec.name}-train-f32", lambda: float(step(state, *batch)[1]["loss"]),
                 TRAIN_BATCH, steps=3)

    step_bf16 = build_train_step(spec, dtype=torch.bfloat16)
    attn.reset_launch_counts()
    lat, losses = [], []
    for _ in range(BF16_STEPS):
        t0 = time.perf_counter()
        state, m = step_bf16(state, *batch)
        losses.append(float(m["loss"]))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches_bf16 = attn.launch_counts()
    want = {"flash_attention": 0, "flash_attention_partials": depth * BF16_STEPS,
            "flash_gfold": 0}
    if launches_bf16 != want or not np.isfinite(losses).all():
        _fail(f"bf16 train steps: launches {launches_bf16} != {want}, losses {losses}")
    summary["bf16"] = dict(steps=BF16_STEPS, losses=losses, step_ms=lat, launches=launches_bf16)
    if profile:
        _profile(f"{spec.name}-train-bf16", lambda: float(step_bf16(state, *batch)[1]["loss"]),
                 TRAIN_BATCH, steps=3)
    return summary, launches["flash_attention_partials"]


# The train-bn phase: the BatchNorm families' train mode (fit from an image
# folder, checkpoint, resume, export, serve).  The folder holds every
# committed JPEG and PNG fixture TRAIN_BN_COPIES times under new names,
# spread over the ten clothing labels (96 images: three batches of 32).
TRAIN_BN_COPIES = 3
BN_STAT_TOL = 1e-5  # relative, a running statistic against 0.99 old + 0.01 batch (float64)
# family spec name -> the BatchNorms whose running statistics are recomputed:
# the first (most values a channel) and the last (fewest: the biased
# variance's n/(n-1) is largest there).
TRAIN_BN_CHECKED = {
    "clothing-model": ("block1_conv1_bn", "block14_sepconv2_bn"),
    "resnet50-imagenet": ("conv1_bn", "conv5_block3.3_bn"),
    "efficientnet-b3-imagenet": ("stem_bn", "top_bn"),
}


def _bn_folder(root: str, spec) -> int:
    """``root/<label>/<file>``: each committed JPEG and PNG fixture
    TRAIN_BN_COPIES times under a new name, the labels taken in turn."""
    import shutil

    files = sorted(os.path.join(d, f) for d in (GW_FIXTURES, FORMATS_DIR)
                   for f in os.listdir(d) if f.endswith((".jpg", ".png")))
    for label in spec.labels:
        os.makedirs(os.path.join(root, label))
    n = 0
    for copy in range(TRAIN_BN_COPIES):
        for path in files:
            label = spec.labels[n % len(spec.labels)]
            ext = os.path.splitext(path)[1]
            shutil.copyfile(path, os.path.join(root, label, f"{label}-{copy}-{n:04d}{ext}"))
            n += 1
    return n


def _bn_stats_step(spec, state, step_fn, images, labels):
    """One train step, with the running statistics of the family's
    TRAIN_BN_CHECKED BatchNorms held against ``0.99 * old + 0.01 * stat``:
    ``stat`` the batch mean and the biased variance, recomputed in float64
    from the layer's input, which a train-mode forward of the same weights
    captures before the step.  Returns (state, metrics, check)."""
    from kubernetes_deep_learning_tpu_torch.models import create_model
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize

    names = TRAIN_BN_CHECKED[spec.name]
    model = create_model(spec).cuda()
    model.load_state_dict({k: t.detach() for k, t in {**state.params,
                                                       **state.batch_stats}.items()})
    mods, inputs = dict(model.named_modules()), {}
    hooks = [mods[n].register_forward_pre_hook(
        lambda m, args, n=n: inputs.__setitem__(n, args[0].double())) for n in names]
    with torch.no_grad():
        model(normalize(images, spec.preprocessing), train=True)
    for h in hooks:
        h.remove()
    del model
    old = {n: {s: state.batch_stats[f"{n}.running_{s}"].double().clone() for s in ("mean", "var")}
           for n in names}
    state, metrics = step_fn(state, images, labels)
    check = {}
    for n in names:
        x = inputs.pop(n)
        dims = tuple(range(x.dim() - 1))
        count = x[..., 0].numel()
        batch = {"mean": x.mean(dims)}
        batch["var"] = ((x - batch["mean"]) ** 2).mean(dims)
        row = {"values_per_channel": count}
        for s in ("mean", "var"):
            want = 0.99 * old[n][s] + 0.01 * batch[s]
            got = state.batch_stats[f"{n}.running_{s}"].double()
            row[f"{s}_rel"] = float((got - want).abs().max() / want.abs().max())
            if not row[f"{s}_rel"] < BN_STAT_TOL:
                _fail(f"{spec.name} {n}: running {s} {row[f'{s}_rel']:.3e} off 0.99 old + "
                      f"0.01 batch {s} (float64) > {BN_STAT_TOL}")
        unbiased = 0.99 * old[n]["var"] + 0.01 * batch["var"] * count / (count - 1)
        want = 0.99 * old[n]["var"] + 0.01 * batch["var"]
        row["unbiased_var_rel"] = float((unbiased - want).abs().max() / want.abs().max())
        # At the last BatchNorm (fewest values) the unbiased variance's
        # running value lies well outside the port's error: this tells
        # flax's biased variance from F.batch_norm's on the card.
        if n == names[-1] and not row["var_rel"] < row["unbiased_var_rel"] / 10:
            _fail(f"{spec.name} {n}: running var error {row['var_rel']:.3e} does not tell "
                  f"the biased variance from the unbiased ({row['unbiased_var_rel']:.3e})")
        check[n] = row
    return state, metrics, check


def _timed_steps(spec, state, images, labels, steps: int = TIMED_STEPS, dtype=None):
    """``steps`` train steps on a device batch, each synced: (state, p50
    ms, peak device GiB of the run).  Non-finite losses fail."""
    from kubernetes_deep_learning_tpu_torch.training import build_train_step

    step = build_train_step(spec, dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, images, labels)
        losses.append(float(m["loss"]))
        lat.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(losses).all():
        _fail(f"{spec.name} {dtype or 'float32'} train steps: losses {losses}")
    return state, float(np.median(lat)), torch.cuda.max_memory_allocated() / 2**30


def _serve_trained(spec, d: str, state, images: np.ndarray, *, per_forward: dict,
                   tol: float) -> dict:
    """The exported version ``d`` on the card (graph buckets 1 and 16):
    the default (bf16) route's launches a forward and its logits against
    the trained state's exact float32 eval forward (within ``tol``, top-1
    agreement reported), and the engine's float32 graph within
    F32_KERNEL_TOL of it."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import build_forward
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    tensors = {k: t.detach() for k, t in {**state.params, **state.batch_stats}.items()}
    engine = InferenceEngine(art.load_artifact(d), buckets=(1, 16), device="cuda")
    try:
        engine.warmup()
        imgs = images[:16]
        for m in _kernel_modules():
            m.reset_launch_counts()
        served = np.concatenate([engine.predict(imgs), engine.predict(imgs[:1])])
        launches = {k: v for m in _kernel_modules() for k, v in m.launch_counts().items()}
        want_launches = {k: 0 for k in launches} | {k: 2 * v for k, v in per_forward.items()}
        if launches != want_launches:
            _fail(f"{spec.name} trained artifact: launches {launches} != {want_launches} "
                  "for two forwards")
        with torch.inference_mode():
            exact = build_forward(spec, tensors, torch.float32, False, "cuda")(
                torch.from_numpy(imgs).cuda()).cpu().numpy()
            x = normalize(torch.from_numpy(imgs), spec.preprocessing).numpy()
        exact = np.concatenate([exact, exact[:1]])
        f32 = engine.predict(x)
    finally:
        engine.close()
    if not np.isfinite(served).all() or served.shape != (17, spec.num_classes):
        _fail(f"{spec.name} trained artifact: logits {served.shape}, finite "
              f"{np.isfinite(served).all()}")
    scale = np.abs(exact).max() + 1e-6
    rel = float(np.abs(served - exact).max() / scale)
    rel_f32 = float(np.abs(f32 - exact[:16]).max() / scale)
    if not rel < tol or not rel_f32 < F32_KERNEL_TOL:
        _fail(f"{spec.name} trained artifact: served vs the trained eval forward: bf16 "
              f"{rel:.3e} (tol {tol}), f32 {rel_f32:.3e} (tol {F32_KERNEL_TOL})")
    return dict(launches_two_forwards=launches, bf16_vs_eval_rel=rel, tol_rel=tol,
                top1_agree=float((served.argmax(-1) == exact.argmax(-1)).mean()),
                f32_vs_eval_rel=rel_f32, f32_tol_rel=F32_KERNEL_TOL)


def _train_bn_family(spec, seed: int, smi: str, steps: int, *, per_forward: dict,
                     tol: float) -> dict:
    """ResNet50 or EfficientNet-B3 at full width: ``steps`` fit() steps on a
    repeated synthetic batch (the loss must fall), the running-statistics
    check, step p50, img/s and peak memory, then the export served once."""
    from kubernetes_deep_learning_tpu_torch.export.exporter import export_model
    from kubernetes_deep_learning_tpu_torch.training import (
        build_train_step,
        create_train_state,
        fit,
    )

    tx = functools.partial(torch.optim.Adam, lr=TRAIN_LR, eps=1e-8)
    (images, labels), repeat = _train_batches(spec, seed)
    dev = tuple(torch.as_tensor(a, device="cuda") for a in (images, labels))
    state = create_train_state(spec, tx, seed=seed, device="cuda")
    state, m, stats = _bn_stats_step(spec, state, build_train_step(spec), *dev)
    out = dict(model=spec.name, batch=TRAIN_BATCH, dtype="float32", optimizer="adam",
               lr=TRAIN_LR, input=list(spec.input_shape), running_stats=stats, card=smi)
    state, hist = fit(spec, tx, repeat(steps), 1 + steps, state=state, log_every=1,
                      log_fn=lambda s: None)
    losses = [m["loss"].item()] + [loss for _, loss in hist]
    if len(losses) != 1 + steps or not np.isfinite(losses).all():
        _fail(f"{spec.name} train-bn fit: losses {losses}")
    if not losses[-1] < losses[0]:
        _fail(f"{spec.name} train-bn: the loss did not fall: {losses}")
    state, p50, peak = _timed_steps(spec, state, *dev)
    device_ms = _profile(f"{spec.name}-train-f32", lambda: _timed_steps(
        spec, state, *dev, steps=1), TRAIN_BATCH, steps=2)
    with tempfile.TemporaryDirectory() as tmp:
        d = export_model(spec, state.variables(), f"{tmp}/models")
        served = _serve_trained(spec, d, state, images, per_forward=per_forward, tol=tol)
    out.update(steps=1 + steps, losses=losses, step_ms_p50=p50,
               img_per_s=TRAIN_BATCH / (p50 / 1e3), peak_mem_gib=peak,
               device_ms_per_step=device_ms, served=served)
    return out


def _train_bn_phase(seed: int, smi: str, *, per_forward: dict) -> dict:
    """``clothing-model`` (Xception at 299 px with its 100-unit hidden head,
    full width, f32, Adam) fine-tuned from an image folder of the committed
    fixtures: ``fit`` through ``image_folder_batches`` with checkpoints
    and an eval pass at the cadence and at the end; TRAIN_STEPS steps on
    one repeated batch (the loss must fall); the running-statistics check;
    the step-TRAIN_STEPS checkpoint restored into a fresh state (bit-equal
    parameters and statistics) and resumed for 2 steps; ``fit_and_export``
    and the artifact served on the card (8 K1 + 2 K2 a forward); step p50,
    img/s, peak memory, then BF16_STEPS bf16 steps."""
    from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL as spec
    from kubernetes_deep_learning_tpu_torch.training import (
        Checkpointer,
        build_train_step,
        create_train_state,
        fit,
        fit_and_export,
        image_folder_batches,
    )

    tx = functools.partial(torch.optim.Adam, lr=TRAIN_LR, eps=1e-8)
    out = dict(model=spec.name, batch=TRAIN_BATCH, dtype="float32", optimizer="adam",
               lr=TRAIN_LR, input=list(spec.input_shape), card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt_dir, root = f"{tmp}/data", f"{tmp}/ckpt", f"{tmp}/models"
        out["folder_images"] = _bn_folder(data, spec)
        batches = functools.partial(image_folder_batches, data, spec, TRAIN_BATCH, seed=seed)
        first = next(batches(epochs=1))
        dev = tuple(torch.as_tensor(a, device="cuda") for a in first)

        # --- the main path: image folder -> fit() -> train_step -> BatchNorm train mode ---
        logs, evals = [], []
        state = create_train_state(spec, tx, seed=seed, device="cuda")
        t0 = time.perf_counter()
        state, hist = fit(spec, tx, batches(), TRAIN_STEPS, state=state, ckpt_dir=ckpt_dir,
                          ckpt_every=TRAIN_STEPS // 2, log_every=1, log_fn=logs.append,
                          eval_batches=lambda: batches(epochs=1), eval_every=TRAIN_STEPS // 2,
                          eval_history=evals)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        losses = [loss for _, loss in hist]
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
            _fail(f"{spec.name} train-bn fit from the folder: losses {losses}")
        if [s for s, _ in evals] != [TRAIN_STEPS // 2, TRAIN_STEPS] or not all(
                np.isfinite(m["val_loss"]) for _, m in evals):
            _fail(f"{spec.name} train-bn: eval passes {evals}")
        out.update(folder_fit_s=fit_s, folder_losses=losses,
                   evals=[dict(step=s, **m) for s, m in evals])

        # --- the checkpoint: restore into a fresh state, bit-equal; resume 2 steps ---
        fresh = create_train_state(spec, tx, seed=seed + 1, device="cuda")
        with Checkpointer(ckpt_dir) as ckpt:
            if ckpt.restore(fresh) is None or fresh.step != TRAIN_STEPS:
                _fail(f"{spec.name} checkpoint restore: step {fresh.step}")
        for name in ("params", "batch_stats"):
            live, got = getattr(state, name), getattr(fresh, name)
            if not live or not all(torch.equal(got[k], t) for k, t in live.items()):
                _fail(f"{spec.name} checkpoint restore: {name} differ from the trained state's")
        logs.clear()
        fresh, _ = fit(spec, tx, batches(), TRAIN_STEPS + 2, state=fresh, ckpt_dir=ckpt_dir,
                       log_fn=logs.append)
        if fresh.step != TRAIN_STEPS + 2 or not any("resumed" in x for x in logs):
            _fail(f"{spec.name} resume: step {fresh.step}, log {logs}")
        del fresh

        # --- fit_and_export (resumed at TRAIN_STEPS + 2: no new step), served ---
        d = fit_and_export(spec, tx, batches(), TRAIN_STEPS + 2, root, ckpt_dir=ckpt_dir,
                           seed=seed + 2, log_fn=logs.append)
        trained = create_train_state(spec, tx, seed=seed + 3, device="cuda")
        with Checkpointer(ckpt_dir) as ckpt:
            ckpt.restore(trained)
            out["checkpoint_steps"] = ckpt.all_steps()
        out["served"] = _serve_trained(spec, d, trained, first[0], per_forward=per_forward,
                                       tol=MODEL_TOL)
        del trained

    # --- TRAIN_STEPS steps on one repeated batch: the loss falls ---
    state = create_train_state(spec, tx, seed=seed, device="cuda")
    state, m, out["running_stats"] = _bn_stats_step(spec, state, build_train_step(spec), *dev)
    losses = [m["loss"].item()]
    state, hist = fit(spec, tx, itertools.repeat(first, TRAIN_STEPS - 1), TRAIN_STEPS,
                      state=state, log_every=1, log_fn=lambda s: None)
    losses += [loss for _, loss in hist]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"{spec.name} train-bn on a repeated batch: the loss did not fall: {losses}")
    out["repeated_batch_losses"] = losses

    # --- step time: f32 steps, each synced; then bf16 steps ---
    state, p50, peak = _timed_steps(spec, state, *dev)
    out.update(step_ms_p50=p50, img_per_s=TRAIN_BATCH / (p50 / 1e3), peak_mem_gib=peak)
    out["device_ms_per_step"] = _profile(f"{spec.name}-train-f32", lambda: _timed_steps(
        spec, state, *dev, steps=1), TRAIN_BATCH, steps=2)
    state, p50, peak = _timed_steps(spec, state, *dev, steps=BF16_STEPS, dtype=torch.bfloat16)
    out["bf16"] = dict(steps=BF16_STEPS, step_ms_p50=p50, peak_mem_gib=peak)
    return out


def _mbconv_bound(b: int, h: int, c_in: int, c_mid: int, c_out: int, s: int, k: int,
                  exp_rate: float) -> tuple[float, str, dict]:
    """Least time (ms) for one MBConv call: the block's input, output and
    weights moved once; bf16 GEMMs (expand, project, the two SE products)
    on the tensor cores plus the f32 depthwise taps on the CUDA cores; one
    exponential per silu and sigmoid."""
    m = b * h * h
    gemm = 2 * m * c_mid * (c_in + c_out) + 4 * b * c_mid * s
    dw = 2 * k * k * m * c_mid
    wbytes = (2 * (c_in * c_mid + 2 * c_mid * s + c_mid * c_out)
              + 4 * (k * k * c_mid + 5 * c_mid + s + 2 * c_out))
    t = {"bytes": (2 * m * (c_in + c_out) + wbytes) / PEAK_BYTES,
         "products": gemm / PEAK_BF16 + dw / PEAK_F32,
         "exp": (2 * m * c_mid + b * (s + c_mid)) / exp_rate}
    top = max(t, key=t.get)
    return t[top] * 1e3, ("bytes" if top == "bytes" else "operations"), {
        key: v * 1e3 for key, v in t.items()}


def _library_mbconv(x, w, dw_oihw, residual: bool):
    """cuBLAS matmuls, a cuDNN depthwise conv2d and torch elementwise ops:
    the yardstick for K4, not the port."""
    F, bf = torch.nn.functional, torch.bfloat16
    y = F.silu(torch.matmul(x, w["expand_w"]).float() * w["expand_s"] + w["expand_b"]).to(bf)
    k = dw_oihw.shape[-1]
    d = F.conv2d(y.permute(0, 3, 1, 2), dw_oihw, None, 1, k // 2, 1, y.shape[-1])
    y = F.silu(d.permute(0, 2, 3, 1).float() * w["dw_s"] + w["dw_b"]).to(bf)
    m = y.float().mean(dim=(1, 2)).to(bf)
    r = F.silu(torch.matmul(m, w["se_r_w"]).float() + w["se_r_b"]).to(bf)
    g = torch.sigmoid(torch.matmul(r, w["se_e_w"]).float() + w["se_e_b"])
    y = (y.float() * g[:, None, None, :]).to(bf)
    z = (torch.matmul(y, w["proj_w"]).float() * w["proj_s"] + w["proj_b"]).to(bf)
    return x + z if residual else z


def _mbconv_split_ms(ops, x, w, residual: bool, iters: int) -> dict[str, float]:
    """Device time of each of K4's three launches alone (CUDA-graph replay):
    a launch alone reads the scratch as it finds it, so only its time counts."""
    dims = ops._check(x, w, residual)
    return {part: _graph_ms(functools.partial(ops._launch, x, w, dims, residual, bit), iters)
            for part, bit in zip(MBCONV_PHASES, (ops.PHASE_EXPAND_DW, ops.PHASE_SE,
                                                 ops.PHASE_PROJECT))}


def _mbconv_phase(b3_params, seed: int, iters: int, gen: torch.Generator,
                  exp_rate: float) -> dict:
    """K4 at every fused block shape of a bucket-16 EfficientNet-B3 forward
    (each with the weights of its first block), at batch 3, and at B0's
    first fused block (S = 6), against its plain version; the record for
    the ``kernels`` line sums the 18 calls of one forward."""
    from kubernetes_deep_learning_tpu_torch.modelspec import ModelSpec
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.efficientnet import block_plan, round_filters
    from kubernetes_deep_learning_tpu_torch.models.efficientnet_fast import block_routes
    from kubernetes_deep_learning_tpu_torch.ops import fused_mbconv as ops
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables, mbconv_block_weights

    def fused_blocks(width, depth, px):
        stem = -(-px // 2)
        return [r for r in block_routes(block_plan(width, depth), stem, stem,
                                        round_filters(32, width)) if r.fused]

    b3 = fused_blocks(1.2, 1.4, 300)
    if len(b3) != B3_FUSED_PER_FORWARD:
        _fail(f"EfficientNet-B3 at 300 px fuses {len(b3)} blocks, expected {B3_FUSED_PER_FORWARD}")
    groups: dict[tuple, list] = {}
    for r in b3:
        groups.setdefault((r.h, r.c_in, r.c_in * r.expand, r.features, r.kernel, r.residual),
                          []).append(r.name)
    b0_spec = ModelSpec(name="efficientnet-b0-224", family="efficientnet-b0",
                        input_shape=(224, 224, 3), labels=("a", "b"), preprocessing="torch")
    b0_params = from_jax_variables(init_variables(b0_spec, seed=seed))
    b0_first = fused_blocks(1.0, 1.0, 224)[0]
    b0_shape = (b0_first.h, b0_first.c_in, b0_first.c_in * b0_first.expand, b0_first.features,
                b0_first.kernel, b0_first.residual)
    cases = [  # (batch, shape, params, block, calls per B3 forward)
        *((16, shape, b3_params, names[0], len(names)) for shape, names in groups.items()),
        (3, (19, 136, 816, 136, 5, True), b3_params, groups[(19, 136, 816, 136, 5, True)][0], 0),
        (2, b0_shape, b0_params, b0_first.name, 0),
    ]
    rec = dict(name="fused_mbconv_block", route="cuda", source=SOURCES["fused_mbconv_block"],
               replaces="kubernetes_deep_learning_tpu/ops/fused_mbconv.py:244",
               max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, graph_ms=0.0, library_graph_ms=0.0, tol_rel=KERNEL_TOL,
               split_graph_ms={part: 0.0 for part in MBCONV_PHASES},
               per=f"the {B3_FUSED_PER_FORWARD} calls of one bucket-16 forward of "
                   "efficientnet-b3-imagenet (300 px), summed; errors: max over the checked "
                   "cases; graph_ms: device time, CUDA-graph replay; split_graph_ms: each "
                   "launch's device time alone")
    bound_t = {"bytes": 0.0, "operations": 0.0}
    for batch, (h, c_in, c_mid, c_out, k, residual), params, name, calls in cases:
        w = {key: t.to("cuda") for key, t in mbconv_block_weights(params, name).items()}
        s = w["se_r_w"].shape[1]
        x = torch.randn((batch, h, h, c_in), generator=gen, device="cuda").to(torch.bfloat16)
        kernel = functools.partial(ops.fused_mbconv_block, x, w, residual)
        plain = functools.partial(ops.mbconv_block_reference, x, w, residual)
        dw_oihw = w["dw"].permute(2, 0, 1).unsqueeze(1).to(torch.bfloat16).contiguous()
        library = functools.partial(_library_mbconv, x, w, dw_oihw, residual)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        shape = dict(block=name, batch=batch, hw=h, widths=[c_in, c_mid, c_out], se=s, k=k,
                     residual=residual, calls_per_forward=calls)
        if not torch.isfinite(got.float()).all():
            _fail(f"fused_mbconv_block {shape}: non-finite output")
        if not torch.equal(got, kernel()):
            _fail(f"fused_mbconv_block {shape}: two calls on the same input differ")
        err, rel = _rel(got, want)
        if rel > KERNEL_TOL:
            _fail(f"fused_mbconv_block {shape}: relative error {rel:.3e} > {KERNEL_TOL}")
        t = dict(shape, max_abs_err=err, max_rel_err=rel, tol_rel=KERNEL_TOL,
                 graph_ms=_graph_ms(kernel, iters), library_graph_ms=_graph_ms(library, iters))
        if calls:
            b_ms, b_by, terms = _mbconv_bound(batch, h, c_in, c_mid, c_out, s, k, exp_rate)
            t.update(ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     library_ms=_time_ms(library, iters),
                     library_vs_plain_rel=_rel(library(), want)[1],
                     bound_ms=b_ms, bound_by=b_by, bound_terms_ms=terms,
                     split_graph_ms=_mbconv_split_ms(ops, x, w, residual, iters))
            for key in ("ms", "plain_ms", "library_ms", "bound_ms", "graph_ms", "library_graph_ms"):
                rec[key] += calls * t[key]
            for part, part_ms in t["split_graph_ms"].items():
                rec["split_graph_ms"][part] += calls * part_ms
            bound_t[b_by] += calls * b_ms
        print("kernel-check fused_mbconv_block", json.dumps(t), flush=True)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)
    rec["bound_by"] = max(bound_t, key=bound_t.get)
    return rec


def _entry_bound(b: int, h: int, c_in: int, c_b: int, c_out: int) -> tuple[float, str, dict]:
    """Least time (ms) for one K5 call: x read once, the output written
    once, weights once; bf16 GEMMs (conv2, res, pw1, pw2) on the tensor
    cores plus the f32 depthwise taps on the CUDA cores."""
    h_b, h_o = h - 2, (h - 1) // 2
    m_b, m_o = b * h_b * h_b, b * h_o * h_o
    gemm = 2 * m_b * (9 * c_in * c_b + c_b * c_out + c_out * c_out) + 2 * m_o * c_b * c_out
    dw = 2 * 9 * m_b * (c_b + c_out)
    wbytes = 2 * (9 * c_in * c_b + 2 * c_b * c_out + c_out * c_out) + 4 * (
        9 * (c_b + c_out) + 2 * c_b + 6 * c_out)
    t = {"bytes": (2 * b * h * h * c_in + 2 * m_o * c_out + wbytes) / PEAK_BYTES,
         "operations": gemm / PEAK_BF16 + dw / PEAK_F32}
    top = max(t, key=t.get)
    return t[top] * 1e3, top, {"gemm_gflop": gemm / 1e9, "dw_gflop": dw / 1e9,
                               **{k: v * 1e3 for k, v in t.items()}}


def _library_entry(x, w, conv2_oihw):
    """cuDNN conv2d (conv2 and the depthwise), cuBLAS matmul (the 1x1s),
    torch elementwise and max-pool: the yardstick for K5, not the port."""
    from kubernetes_deep_learning_tpu_torch.models.layers import max_pool_same

    bf = torch.bfloat16
    b = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv2_oihw).permute(0, 2, 3, 1)
    b = torch.relu(b.float() * w["conv2_s"] + w["conv2_b"]).to(bf)
    r = (torch.matmul(b[:, ::2, ::2], w["res"]).float() * w["res_s"] + w["res_b"]).to(bf)
    c = _library_stage(b, dict(dw=w["dw1"], pw=w["pw1"], scale=w["bn1_s"], shift=w["bn1_b"],
                               pre_relu=False, post_relu=True))
    d = _library_stage(c, dict(dw=w["dw2"], pw=w["pw2"], scale=w["bn2_s"], shift=w["bn2_b"],
                               pre_relu=False, post_relu=False))
    return max_pool_same(d) + r


def _entry_kernel_phase(params, iters: int, gen: torch.Generator) -> tuple[dict, dict]:
    """K5 at Xception's entry geometry (batches 1, 3, 16) with the
    clothing model's conv2 + block2 weights, and K2 at the entry path's
    block 3 and 4 shapes (batch 16), against their plain versions; times
    at batch 16.  Returns (K5's record, K2's entry-path shapes)."""
    from kubernetes_deep_learning_tpu_torch import weights
    from kubernetes_deep_learning_tpu_torch.ops import _build, fused_entry
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv as ops

    p = {k: v.to("cuda") for k, v in params.items()}
    w = weights.entry_block_weights(p)
    c_in, c_b, c_out = w["conv2"].shape[0] // 9, w["conv2"].shape[1], w["pw1"].shape[1]
    conv2_oihw = w["conv2"].reshape(3, 3, c_in, c_b).permute(3, 2, 0, 1).contiguous()
    rec = dict(name="fused_entry_block", route="cuda", source=SOURCES["fused_entry_block"],
               replaces="kubernetes_deep_learning_tpu/ops/fused_entry.py:283",
               also_replaces="exp/fused_entry.py:257", max_abs_err=0.0, max_rel_err=0.0,
               tol_rel=KERNEL_TOL, per="one call at (16, 149, 149, 32) -> (16, 74, 74, 128); "
               "errors: max over batches 1, 3, 16; graph_ms: device time, CUDA-graph replay")
    for batch in ENTRY_BATCHES:
        x = torch.randn((batch, 149, 149, c_in), generator=gen, device="cuda").to(torch.bfloat16)
        kernel = functools.partial(fused_entry.fused_entry_block, x, w)
        plain = functools.partial(fused_entry.entry_block_reference, x, w)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        if got.shape != want.shape or not torch.isfinite(got.float()).all():
            _fail(f"fused_entry_block at batch {batch}: shape {tuple(got.shape)} or non-finite")
        err, rel = _rel(got, want)
        if rel > KERNEL_TOL:
            _fail(f"fused_entry_block at batch {batch}: relative error {rel:.3e} > {KERNEL_TOL}")
        t = dict(batch=batch, max_abs_err=err, max_rel_err=rel, tol_rel=KERNEL_TOL)
        if batch == ENTRY_BATCHES[-1]:
            library = functools.partial(_library_entry, x, w, conv2_oihw)
            b_ms, b_by, terms = _entry_bound(batch, 149, c_in, c_b, c_out)
            t.update(ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                     library_ms=_time_ms(library, iters),
                     graph_ms=_graph_ms(kernel, iters), library_graph_ms=_graph_ms(library, iters),
                     library_vs_plain_rel=_rel(library(), want)[1],
                     bound_ms=b_ms, bound_by=b_by, bound_terms=terms,
                     segment_rows=_build.load().kdlt_entry_block_rows(batch, 149, 149))
            rec.update({k: t[k] for k in ("ms", "plain_ms", "library_ms", "graph_ms",
                                          "library_graph_ms", "bound_ms", "bound_by")})
        print("kernel-check fused_entry_block", json.dumps(t), flush=True)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["max_rel_err"] = max(rec["max_rel_err"], rel)

    chain = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_rel_err=0.0,
                 per="blocks 3 and 4 of one bucket-16 entry-kernel forward, summed")
    for block, hw in ((3, 74), (4, 37)):
        stages = [weights.sepconv_stage_weights(p, f"block{block}_sepconv{j}",
                                                f"block{block}_sepconv{j}_bn", True, False)
                  for j in (1, 2)]
        widths = [(s["pw"].shape[0], s["pw"].shape[1]) for s in stages]
        x = torch.randn((16, hw, hw, widths[0][0]), generator=gen, device="cuda").to(torch.bfloat16)
        kernel = functools.partial(ops.fused_sepconv_chain, x, stages)
        plain = functools.partial(ops.sepconv_chain_reference, x, stages)

        def library(x=x, stages=stages):
            y = x
            for s in stages:
                y = _library_stage(y, s)
            return y
        got = kernel()
        torch.cuda.synchronize()
        err, rel = _rel(got, plain())
        if rel > KERNEL_TOL:
            _fail(f"fused_sepconv_chain at {hw}x{hw} {widths}: relative error {rel:.3e}")
        b_ms, b_by = _bound(16 * hw * hw, widths)
        t = dict(block=block, shape=[16, hw, hw], widths=widths, max_abs_err=err, max_rel_err=rel,
                 ms=_time_ms(kernel, iters), plain_ms=_time_ms(plain, max(3, iters // 4)),
                 library_ms=_time_ms(library, iters), bound_ms=b_ms, bound_by=b_by)
        print("kernel-check fused_sepconv_chain", json.dumps(t), flush=True)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            chain[key] += t[key]
        chain["max_rel_err"] = max(chain["max_rel_err"], rel)
    return rec, chain


def _forward_ms(fwd, x, iters: int) -> list[float]:
    """Host-clock ms of device-synced forwards on a device-resident batch."""
    with torch.inference_mode():
        for _ in range(2):
            fwd(x)
        torch.cuda.synchronize()
        lat = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fwd(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def _entry_path_phase(spec, variables, seed: int, iters: int, profile: bool,
                      k5_ms: float) -> dict:
    """The entry-kernel forward (``XceptionFast(entry_kernel=True)``, the
    port of exp/model_fused_entry.py's A/B) on the clothing model's
    weights: 1 K5, 8 K1 and 4 K2 launches per forward; logits against the
    default fused route and the exact f32 graph at batches 1, 3, 16; p50
    and img/s of both routes at buckets 1, 4, 16, in turns."""
    from kubernetes_deep_learning_tpu_torch.models import Forward, build_forward, create_model
    from kubernetes_deep_learning_tpu_torch.models.xception_fast import XceptionFast
    from kubernetes_deep_learning_tpu_torch.ops import fused_entry, fused_sepconv
    from kubernetes_deep_learning_tpu_torch.ops.preprocess import normalize
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    params = from_jax_variables(variables)
    model = create_model(spec, torch.bfloat16)
    model.load_state_dict(params)
    entry = Forward(spec, XceptionFast(model.to("cuda").eval(), entry_kernel=True), True).eval()
    default = build_forward(spec, params, torch.bfloat16, "auto", "cuda")
    exact = build_forward(spec, params, torch.float32, False, "cuda")
    rng = np.random.default_rng(seed + 5)
    batches = [torch.from_numpy(rng.integers(0, 256, (n, *spec.input_shape), np.uint8)).cuda()
               for n in ENTRY_BATCHES]

    def counts():
        return {**fused_entry.launch_counts(), **fused_sepconv.launch_counts()}

    with torch.inference_mode():
        # --- the main path: entry-kernel forward -> K5, K2, K1 ---
        fused_entry.reset_launch_counts()
        fused_sepconv.reset_launch_counts()
        outs = [entry(x) for x in batches]
        torch.cuda.synchronize()
        launches = counts()
        want = {k: v * len(batches) for k, v in ENTRY_PER_FORWARD.items()}
        if launches != want:
            _fail(f"entry-kernel forward: launches {launches} != {want} "
                  f"for {len(batches)} forwards")
        fused_entry.reset_launch_counts()
        fused_sepconv.reset_launch_counts()
        default(batches[0])
        if counts() != {"fused_entry_block": 0, "fused_sepconv_block": 8, "fused_sepconv_chain": 2}:
            _fail(f"default fused route: launches {counts()} per forward")
        rel_default = rel_exact = 0.0
        for x, got in zip(batches, outs):
            if got.shape != (len(x), spec.num_classes) or not torch.isfinite(got).all():
                _fail(f"entry-kernel forward: logits {tuple(got.shape)} or non-finite")
            rel_default = max(rel_default, _rel(got, default(x))[1])
            rel_exact = max(rel_exact, _rel(got, exact(normalize(x, spec.preprocessing)))[1])
    if rel_default > KERNEL_TOL or rel_exact > KERNEL_TOL:
        _fail(f"entry-kernel forward: relative error {rel_default:.3e} against the default "
              f"route, {rel_exact:.3e} against exact f32 (tolerance {KERNEL_TOL})")
    summary = dict(model=spec.name, launches=launches, per_forward=ENTRY_PER_FORWARD,
                   vs_default_rel=rel_default, vs_exact_f32_rel=rel_exact, tol_rel=KERNEL_TOL,
                   buckets=[])
    for b in BUCKETS:
        x = torch.from_numpy(rng.integers(0, 256, (b, *spec.input_shape), np.uint8)).cuda()
        lat = {"default": [], "entry_kernel": []}
        for name in ("default", "entry_kernel", "entry_kernel", "default"):  # in turns
            lat[name] += _forward_ms(default if name == "default" else entry, x, iters // 2)
        summary["buckets"].append({
            f"{name}_{key}": val for name, ms in lat.items() for key, val in (
                ("p50_ms", float(np.median(ms))), ("img_per_s", b * len(ms) / (sum(ms) / 1e3)))
        } | {"bucket": b})
    if profile:
        with torch.inference_mode():
            dev_ms, default_ms = (
                _profile(f"{spec.name}-{name}", lambda f=f: (f(x), torch.cuda.synchronize()), b)
                for name, f in (("entry-kernel", entry), ("default", default)))
        summary.update(device_ms_per_forward=dev_ms, default_device_ms_per_forward=default_ms,
                       k5_share_of_device=k5_ms / dev_ms)
    return summary


def _gfold_phase(iters: int, gen: torch.Generator, exp_rate: float) -> dict:
    """K3G (the port of exp/vit_attn_variants.py's flash_gfold A/B): one
    call per fold at E5's shape is the path whose launches are counted;
    then each fold against the plain version at E5's and ViT-B/16-384's
    shapes, timed beside K3 and SDPA."""
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qkv = {shape: [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3)] for shape in GFOLD_SHAPES}
    # --- the main path: the A/B's folded variants, one call each ---
    attn.reset_launch_counts()
    for g in GFOLD:
        attn.flash_gfold(*qkv[GFOLD_SHAPES[0]], g=g)
    torch.cuda.synchronize()
    launches = attn.launch_counts()
    if launches != {"flash_attention": 0, "flash_attention_partials": 0, "flash_gfold": len(GFOLD)}:
        _fail(f"flash_gfold A/B: launches {launches}")
    rec = dict(name="flash_gfold", route="cuda", source=SOURCES["flash_gfold"],
               replaces="exp/vit_attn_variants.py:121", launches=launches["flash_gfold"],
               max_abs_err=0.0, max_rel_err=0.0, tol_rel=KERNEL_TOL,
               per=f"one call at {GFOLD_SHAPES[0]} bf16, g = {GFOLD[-1]}; errors: max over "
                   "both shapes and every g", shapes=[])
    for shape in GFOLD_SHAPES:
        q, k, v = qkv[shape]
        b, h, s, d = shape
        want = attn.flash_attention_reference(q, k, v)
        b_ms, b_by, terms = _attention_bound(b * h, s, s, d, 2 * 4 * b * h * s * d,
                                             torch.bfloat16, exp_rate)
        t = dict(shape=list(shape), bound_ms=b_ms, bound_by=b_by, bound_terms_ms=terms,
                 plain_ms=_time_ms(lambda: attn.flash_attention_reference(q, k, v),
                                   max(3, iters // 4)),
                 library_ms=_time_ms(lambda: sdpa(q, k, v), iters),
                 library_graph_ms=_graph_ms(lambda: sdpa(q, k, v), iters),
                 k3_ms=_time_ms(lambda: attn.flash_attention(q, k, v), iters),
                 k3_graph_ms=_graph_ms(lambda: attn.flash_attention(q, k, v), iters), by_g={})
        for g in GFOLD:
            kernel = functools.partial(attn.flash_gfold, q, k, v, g=g)
            got = kernel()
            torch.cuda.synchronize()
            err, rel = _rel(got, want)
            if not torch.isfinite(got.float()).all() or rel > KERNEL_TOL:
                _fail(f"flash_gfold {shape} g={g}: relative error {rel:.3e} > {KERNEL_TOL}")
            t["by_g"][g] = dict(ms=_time_ms(kernel, iters), graph_ms=_graph_ms(kernel, iters),
                                max_abs_err=err, max_rel_err=rel, **_flash_plan(shape, g))
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        print("kernel-check flash_gfold", json.dumps(t), flush=True)
        rec["shapes"].append(t)
    main = rec["shapes"][0]
    rec.update(ms=main["by_g"][GFOLD[-1]]["ms"], graph_ms=main["by_g"][GFOLD[-1]]["graph_ms"],
               **{k: main[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by")})
    return rec


# --- int8 quantization: Q1, Q2 and the w8a8 / weight-only servers ---------

QUANT_CALIB_IMAGES = 8
# Noise calibration images have no outliers for the 99.9 clip to remove, so
# they calibrate at 100 (absmax), as tests/test_quantize.py does; the CLI's
# default stays 99.9.
QUANT_CALIB_PERCENTILE = 100.0
QUANT_LAYERS = 68
QUANT_PER_FORWARD = {"int8_conv": 39, "int8_depthwise": 29}
# Kernels of one traced w8a8 replay by name: Q1 is two launches a call, its
# quantize pass (int8_codes_kernel) and its GEMM.
QUANT_TRACE = {"int8_codes_kernel": 39, "int8_conv_kernel": 39, "int8_depthwise_kernel": 29,
               "sepconv_stage_kernel": 0}
QUANT_GRID = 16
CALIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "ingest_fixtures")
PEAK_INT8 = 1979e12  # H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
QUANT_REPLACES_NOTE = ("no pallas_call: the JAX package's w8a8 program runs XLA's int8 "
                       "conv_general_dilated (kubernetes_deep_learning_tpu/ops/quantize.py:358)")
# One module per distinct shape of the 299-px clothing-model's w8a8 forward:
# (module, input side, launches of that shape a forward).
Q1_LAYERS = (
    ("block1_conv2", 149, 1),
    ("block2_res_conv", 147, 1),
    ("block3_res_conv", 74, 1),
    ("block4_res_conv", 37, 1),
    ("block13_res_conv", 19, 1),
    ("block2_sepconv1.pointwise", 147, 1),
    ("block2_sepconv2.pointwise", 147, 1),
    ("block3_sepconv1.pointwise", 74, 1),
    ("block3_sepconv2.pointwise", 74, 1),
    ("block4_sepconv1.pointwise", 37, 1),
    ("block4_sepconv2.pointwise", 37, 1),
    ("block5_sepconv1.pointwise", 19, 25),  # the middle flow's 24 and block13_sepconv1's
    ("block13_sepconv2.pointwise", 19, 1),
    ("block14_sepconv1.pointwise", 10, 1),
    ("block14_sepconv2.pointwise", 10, 1),
)
Q2_LAYERS = (
    ("block4_sepconv2.depthwise", 37, 1),
    ("block5_sepconv1.depthwise", 19, 26),  # the middle flow's 24 and block13's 2
    ("block14_sepconv1.depthwise", 10, 1),
    ("block14_sepconv2.depthwise", 10, 1),
)
QUANT_BATCHES = (16, 3)  # every shape; batch 1 for the middle flow's two


def _taps_read(n_in: int, n_out: int, k: int, stride: int, pad: int) -> int:
    """Input rows (or columns) of one side that a conv's taps read, ``pad``
    the padding before it: a 1x1/2 conv reads every second one."""
    return len({o * stride + t - pad for o in range(n_out) for t in range(k)}
               & set(range(n_in)))


def _pads_before(layer, n_in: tuple[int, int], n_out: tuple[int, int]) -> tuple[int, int]:
    """The top and left padding of an Int8Conv2d's input."""
    if layer.padding == "VALID":
        return 0, 0
    if layer.padding == "SAME":
        return tuple(max((o - 1) * layer.stride + k - i, 0) // 2
                     for i, o, k in zip(n_in, n_out, layer.kernel_size))
    return layer.padding[0][0], layer.padding[1][0]


def _int8_case(layer, batch: int, side: int, gen, iters: int) -> dict:
    """One Int8Conv2d of the w8a8 forward on a card input: the kernel
    against its plain version (max abs difference must be 0); kernel
    (eager and by graph replay), plain version and ``torch._int_mm`` on the
    pre-quantized codes (1x1 stride-1 convs only: the yardstick, used
    nowhere in the port), the bound and the rate.  For Q1 also its quantize
    pass alone as Q1 runs it (bit-equal to its plain version, its device ms
    by replay and its share of Q1's) and the GEMM instance its shape takes."""
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    x = torch.randn((batch, side, side, layer.c_in), generator=gen, device="cuda")
    x = x * (layer.s_act * 60.0)  # codes spread over the int8 range, some clamped
    if layer.kind == "depthwise":
        q_w = int8_ops.unpack_depthwise(layer.packed)
        plain = lambda: int8_ops.int8_conv_reference(  # noqa: E731
            x, q_w, layer.s_act, layer.out_scale, layer.stride, "SAME", layer.c_in, layer.bias)
    else:
        q_w = int8_ops.unpack_conv(layer.packed, layer.c_in, *layer.kernel_size)
        plain = lambda: int8_ops.int8_conv_reference(  # noqa: E731
            x, q_w, layer.s_act, layer.out_scale, layer.stride, layer.padding, 1, layer.bias)
    kernel = lambda: layer(x)  # noqa: E731
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = (got - want).abs().max().item()
    if err != 0 or got.shape != want.shape or not torch.isfinite(got).all():
        _fail(f"{layer.kind} {tuple(x.shape)}->{tuple(want.shape)}: kernel vs plain version: "
              f"max abs difference {err}")
    rec = dict(kind=layer.kind, shape=list(x.shape), out=list(got.shape),
               kernel_size=list(layer.kernel_size), stride=layer.stride,
               padding=layer.padding, bias=layer.bias is not None, max_abs_err=err)
    m = got.shape[0] * got.shape[1] * got.shape[2]
    k = layer.kernel_size[0] * layer.kernel_size[1] * (1 if layer.kind == "depthwise"
                                                        else layer.c_in)
    ops = 2 * m * k * layer.c_out
    pads = _pads_before(layer, tuple(x.shape[1:3]), tuple(got.shape[1:3]))
    if layer.kind == "conv":
        # The quantize pass as Q1 runs it: a 1x1 conv's pixels only.
        sample = ((layer.stride, *pads, *got.shape[1:3]) if layer.kernel_size == (1, 1)
                  else None)
        q8 = int8_ops.int8_codes(x, layer.s_act, sample=sample)
        if not torch.equal(q8.cpu(), int8_ops.int8_codes(x.cpu(), layer.s_act, sample=sample)):
            _fail(f"int8 codes {tuple(x.shape)}: the quantize pass differs from its plain version")
        rec["codes_graph_ms"] = _graph_ms(
            lambda: int8_ops.int8_codes(x, layer.s_act, sample=sample), iters)
        rec["instance"] = list(int8_ops.q1_instance(
            m, layer.c_out, layer.packed.shape[1], tuple(layer.kernel_size),
            torch.cuda.get_device_properties(0).multi_processor_count))
    # x's bytes are those the taps read, each once.
    rows, cols = (_taps_read(n_in, n_out, kk, layer.stride, pad)
                  for n_in, n_out, kk, pad in zip(x.shape[1:3], got.shape[1:3],
                                                  layer.kernel_size, pads))
    x_bytes = batch * rows * cols * layer.c_in * 4
    nbytes = x_bytes + layer.c_out * k + layer.c_out * 4 + got.numel() * 4
    t_ops, t_bytes = ops / PEAK_INT8, nbytes / PEAK_BYTES
    library_ms = None
    if layer.kind == "conv" and layer.kernel_size == (1, 1) and layer.stride == 1:
        codes = int8_ops.quantize_input(x, layer.s_act).to(torch.int8).reshape(m, layer.c_in)
        for wt in (q_w[:, :, 0, 0].t(), q_w[:, :, 0, 0].t().contiguous()):  # (C_in, C_out)
            try:
                library_ms = _time_ms(lambda wt=wt: torch._int_mm(codes, wt), iters)
                break
            except RuntimeError as e:  # a layout cuBLASLt refuses: try the other
                rec["library_error"] = str(e).splitlines()[0]
    rec.update(ms=_time_ms(kernel, iters), graph_ms=_graph_ms(kernel, iters),
               plain_ms=_time_ms(plain, max(3, iters // 4)), library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="bytes" if t_bytes > t_ops else "operations", int8_ops=ops, bytes=nbytes,
               x_bytes_read=x_bytes)
    rec["tops"] = ops / (rec["graph_ms"] * 1e-3) / 1e12
    if "codes_graph_ms" in rec:
        rec["codes_share"] = rec["codes_graph_ms"] / rec["graph_ms"]
    return rec


def _int8_kernel_phase(forward, gen, iters: int, smi: str) -> list[dict]:
    """Q1 and Q2 at every shape of the forward (batches 16 and 3; batch 1
    for the middle flow's), against their plain versions; returns the two
    ``kernels`` records, each summed over the calls of one bucket-16
    forward."""
    records = []
    for name, layers in (("int8_conv", Q1_LAYERS), ("int8_depthwise", Q2_LAYERS)):
        rec = dict(name=name, route="cuda", source=_CSRC + "int8_conv.cu", replaces=None,
                   replaces_note=QUANT_REPLACES_NOTE, max_abs_err=0.0, ms=0.0, graph_ms=0.0,
                   plain_ms=0.0, bound_ms=0.0, library_ms=None, **_int8_extra_sums(name),
                   per=f"the {sum(n for *_, n in layers)} calls of one bucket-16 forward, summed",
                   tol_abs=0.0, shapes=[])
        bound_t = {"bytes": 0.0, "operations": 0.0}
        for module, side, per_forward in layers:
            layer = forward.inner.get_submodule(module)
            batches = QUANT_BATCHES + ((1,) if per_forward > 1 else ())
            for b in batches:
                t = _int8_case(layer, b, side, gen, iters)
                print("int8-kernel:", json.dumps({"name": name, "module": module, "batch": b,
                                                  "per_forward": per_forward, **t, "card": smi}),
                      flush=True)
                rec["max_abs_err"] = max(rec["max_abs_err"], t["max_abs_err"])
                if b == 16:
                    for key in ("ms", "graph_ms", "plain_ms", "bound_ms"):
                        rec[key] += per_forward * t[key]
                    _add_int8_extra(rec, t, per_forward)
                    bound_t[t["bound_by"]] += per_forward * t["bound_ms"]
                    rec["shapes"].append(t["shape"])
        rec["bound_by"] = max(bound_t, key=bound_t.get)
        _finish_int8_extra(rec)
        records.append(rec)
    return records


def _int8_extra_sums(name: str) -> dict:
    """Q1's extra fields: its two device kernels a wrapper call (its count
    is the wrapper's), and sums over a forward's calls of its quantize
    pass's device ms and of ``torch._int_mm`` on pre-quantized codes over
    the 1x1 stride-1 calls (int8 GEMM with int32 out only: no quantize-in,
    no f32 epilogue; not the layer's function, so not its ``library_ms``)."""
    if name != "int8_conv":
        return {}
    return dict(device_kernels=["int8_codes_kernel", "int8_conv_kernel"], codes_graph_ms=0.0,
                int_mm_ms=0.0, int_mm_calls=0)


def _add_int8_extra(rec: dict, t: dict, calls: int) -> None:
    if "codes_graph_ms" in rec:
        rec["codes_graph_ms"] += calls * t["codes_graph_ms"]
        if t["library_ms"] is not None:
            rec["int_mm_ms"] += calls * t["library_ms"]
            rec["int_mm_calls"] += calls


def _finish_int8_extra(rec: dict) -> None:
    if "codes_graph_ms" in rec and rec["graph_ms"]:
        rec["codes_share"] = rec["codes_graph_ms"] / rec["graph_ms"]


def _engine_bytes(make) -> tuple:
    """(engine, device bytes its construction allocated: its parameters,
    before any graph is captured)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = make()
    torch.cuda.synchronize()
    return engine, torch.cuda.memory_allocated() - before


def _serve_checked(root: str, spec, batches, *, scheme: str, active: str, per_forward: dict,
                   counters) -> tuple[list, dict, str]:
    """Serve ``root`` (one version of ``spec``) on the card; the batches as
    msgpack ``:predict`` requests must launch ``per_forward`` kernels a
    forward (``counters``' counts, every other kernel of theirs none), and
    ``:status`` must report the scheme requested and the one serving.
    Returns (replies, launches, /metrics text)."""
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    server = ModelServer(root, port=0, buckets=BUCKETS, device="cuda")
    try:
        server.start()
        server.warmup()
        status = _http_json(server.port, f"/v1/models/{spec.name}:status")[1]
        if (status["quantization"], status["quantization_active"]) != (scheme, active):
            _fail(f"quant: {root}: :status {status['quantization']!r}/"
                  f"{status['quantization_active']!r}, expected {scheme!r}/{active!r}")
        url = f"http://127.0.0.1:{server.port}/v1/models/{spec.name}:predict"
        for c in counters:
            c.reset_launch_counts()
        replies = [_post(url, imgs, "msgpack") for imgs in batches]
        launches = {k: v for c in counters for k, v in c.launch_counts().items()}
        want = {k: per_forward.get(k, 0) * len(batches) for k in launches}
        if launches != want:
            _fail(f"quant: {active}: kernel launches {launches} != {want} "
                  f"for {len(batches)} forwards")
        for imgs, (got, labels, _) in zip(batches, replies):
            if got.shape != (len(imgs), spec.num_classes) or not np.isfinite(got).all():
                _fail(f"quant: {active}: logits {got.shape} for a batch of {len(imgs)}")
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        server.shutdown()
    return [got for got, _, _ in replies], launches, metrics


def _quant_phase(spec, seed: int, iters: int, smi: str, gen,
                 profile: bool = False) -> tuple[dict, list[dict]]:
    """clothing-model at 299 px as int8: v2 weight-only and v3 w8a8 written
    by the port's ``write_quantized_version`` (calibrated on the card), v4 a
    miscalibrated v3; Q1 and Q2 against their plain versions at every shape;
    v3, v2 and v4 served; p50 of the w8a8, weight-only and bf16 fused
    engines in turns (with ``profile``, each traced at bucket 16).  Returns
    (summary, the Q1 and Q2 kernel records)."""
    import shutil

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.ops import fused_sepconv
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
    from kubernetes_deep_learning_tpu_torch.ops import quantize
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    out: dict = {"model": spec.name}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "versions")
        art.save_artifact(art.version_dir(root, spec.name, 1), spec,
                          init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"})
        v2 = quantize.write_quantized_version(root, spec.name, quantize.SCHEME)
        # --calibrate-dir's images on this machine, which has no PIL (C8):
        # the committed JPEG and PNG fixtures, decoded and resized as the
        # gateway does them, cycled.
        real = quantize.representative_images(spec, QUANT_CALIB_IMAGES, image_dir=CALIB_DIR)
        if real.shape != (QUANT_CALIB_IMAGES, *spec.input_shape) or real.dtype != np.uint8:
            _fail(f"quant: calibration images from {CALIB_DIR}: {real.shape} {real.dtype}")
        out["calibrate_dir"] = dict(images=len(real), mean=float(real.mean()))
        calib = quantize.representative_images(spec, QUANT_CALIB_IMAGES, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v3 = quantize.write_quantized_version(
            root, spec.name, quantize.SCHEME_W8A8, calib_images=calib,
            percentile=QUANT_CALIB_PERCENTILE, from_version=1)
        out["calibration_s"] = time.perf_counter() - t0
        w8a8 = art.load_artifact(v3)
        out["calibration"] = w8a8.metadata["calibration"]
        if out["calibration"]["layers"] != QUANT_LAYERS:
            _fail(f"quant: calibration scaled {out['calibration']['layers']} layers, "
                  f"expected {QUANT_LAYERS}")
        print("quant-calibration:", json.dumps({**out, "card": smi}), flush=True)

        def scaled(tree):  # every activation scale x1000: a stale calibration
            if not isinstance(tree, dict):
                return tree
            new = {k: scaled(v) for k, v in tree.items()}
            if quantize.ACT_SCALE_KEY in tree:
                new[quantize.ACT_SCALE_KEY] = np.asarray(
                    tree[quantize.ACT_SCALE_KEY] * np.float32(1e3), np.float32)
            return new

        roots = {}
        for tag, src in (("w8a8", v3), ("weight-only", v2)):
            roots[tag] = os.path.join(tmp, tag)
            shutil.copytree(src, art.version_dir(roots[tag], spec.name, 1))
        roots["miscalibrated"] = os.path.join(tmp, "miscalibrated")
        art.save_artifact(art.version_dir(roots["miscalibrated"], spec.name, 1), spec,
                          scaled(w8a8.variables), w8a8.metadata)

        # --- the engines: device bytes, the gate, the kernels at their shapes ---
        wo_art = art.load_artifact(v2)
        deq = art.ModelArtifact(spec, quantize.dequantize_variables_host(wo_art.variables),
                                {"compute_dtype": "bfloat16"})
        engines, param_bytes = {}, {}
        for tag, artifact in (("w8a8", w8a8), ("weight-only", wo_art), ("bf16-fused", deq)):
            engines[tag], param_bytes[tag] = _engine_bytes(
                lambda a=artifact: InferenceEngine(a, buckets=BUCKETS, device="cuda"))
            engines[tag].warmup()
        out["param_bytes_on_device"] = param_bytes
        e3 = engines["w8a8"]
        if e3.quantization_active != quantize.SCHEME_W8A8 or e3.fast:
            _fail(f"quant: v3 serves {e3.quantization_active} (gate drift "
                  f"{e3.quant_gate_drift}, top-1 {e3.quant_gate_top1})")
        out["gate"] = dict(drift=e3.quant_gate_drift, top1=e3.quant_gate_top1,
                           tol=quantize.resolve_quant_tol(), top1_min=quantize.GATE_TOP1)
        records = _int8_kernel_phase(e3._forward, gen, iters, smi)

        # --- the main path: v3 (w8a8) served over msgpack ---
        rng = np.random.default_rng(seed + 21)
        batches = [rng.integers(0, 256, (n, *spec.input_shape), np.uint8) for n in REQUESTS]
        replies, launches, metrics = _serve_checked(
            roots["w8a8"], spec, batches, scheme=quantize.SCHEME_W8A8,
            active=quantize.SCHEME_W8A8, per_forward=QUANT_PER_FORWARD,
            counters=(int8_ops, fused_sepconv))
        for rec in records:
            rec["launches"] = launches[rec["name"]]
        out["w8a8_launches"] = launches
        for imgs, got in zip(batches, replies):
            if not np.array_equal(got, e3.predict(imgs)):
                _fail("quant: a w8a8 reply differs from the same artifact's engine")
        gauge = _metric_samples(metrics, "kdlt_quant_scheme", spec.name)
        if [v for k, v in gauge.items() if 'scheme="int8-w8a8"' in k] != [1.0]:
            _fail(f"quant: kdlt_quant_scheme on /metrics: {gauge}")

        # --- v2 (weight-only): the fused path on the dequantized tree ---
        replies, out["weight_only_launches"], _ = _serve_checked(
            roots["weight-only"], spec, batches, scheme=quantize.SCHEME, active=quantize.SCHEME,
            per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2},
            counters=(int8_ops, fused_sepconv))
        for imgs, got in zip(batches, replies):
            if not np.array_equal(got, engines["bf16-fused"].predict(imgs)):
                _fail("quant: weight-only logits differ from float serving of the "
                      "dequantized tree")

        # --- v4: the gate refuses it; weight-only serves ---
        _, out["refused_launches"], metrics = _serve_checked(
            roots["miscalibrated"], spec, batches[:1], scheme=quantize.SCHEME_W8A8,
            active=quantize.SCHEME, per_forward={"fused_sepconv_block": 8,
                                                 "fused_sepconv_chain": 2},
            counters=(int8_ops, fused_sepconv))
        failures = _metric_samples(metrics, "kdlt_quant_gate_failures_total", spec.name)
        if list(failures.values()) != [1.0]:
            _fail(f"quant: kdlt_quant_gate_failures_total on /metrics: {failures}")
        out["refused_gate_failures"] = failures

        # --- w8a8 against weight-only; graphs, trace; p50 in turns ---
        grid = _grid_images(spec, QUANT_GRID, seed + 22)
        got, ref = e3.predict(grid), engines["weight-only"].predict(grid)
        drift = float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))
        top1 = float((got.argmax(-1) == ref.argmax(-1)).mean())
        out["grid"] = dict(images=QUANT_GRID, drift=drift, top1=top1)
        if drift > quantize.resolve_quant_tol() or top1 < quantize.GATE_TOP1:
            _fail(f"quant: w8a8 vs weight-only on the grid: drift {drift:.4f}, top-1 {top1}")
        out["graphs"] = _graph_check(e3, f"{spec.name}-w8a8", seed + 23)
        if not out["graphs"]["all_bit_equal"]:
            _fail(f"quant: a w8a8 bucket graph is not bit-equal to eager: {out['graphs']}")
        out["trace_launches"] = _trace_check(e3, f"{spec.name}-w8a8", seed + 24, QUANT_TRACE)
        lat: dict = {tag: {b: [] for b in BUCKETS} for tag in engines}
        for b in BUCKETS:
            imgs = rng.integers(0, 256, (b, *spec.input_shape), np.uint8)
            for e in engines.values():
                e.predict(imgs)
            for _ in range(iters):
                for tag, e in engines.items():
                    t0 = time.perf_counter()
                    e.predict(imgs)
                    lat[tag][b].append((time.perf_counter() - t0) * 1e3)
        out["p50_ms"] = {tag: {str(b): float(np.median(v)) for b, v in d.items()}
                         for tag, d in lat.items()}
        if profile:
            for tag, e in engines.items():
                _profile(f"{spec.name}-{tag}", functools.partial(e.predict, imgs), len(imgs))
        for e in engines.values():
            e.close()
    return out, records


# int8 for ResNet50 and EfficientNet-B3 (A8c): Q1 and Q2 launches a
# forward (one per calibrated layer: ResNet50's 53 convolutions; B3's 82
# dense and 20 depthwise convolutions of at least 4096 weights), and the
# timed repetitions of this phase's kernel checks and p50s, cut so the two
# families add at most 90 s to the run.
QUANT_FAMILIES = {
    "resnet50-imagenet": {"int8_conv": 53, "int8_depthwise": 0},
    "efficientnet-b3-imagenet": {"int8_conv": 82, "int8_depthwise": 20},
}
QUANT_FAMILY_ITERS = 3
QUANT_FAMILY_WEIGHT_ONLY = {  # launches a forward of the weight-only (bf16) arm
    "resnet50-imagenet": {},
    "efficientnet-b3-imagenet": {"fused_mbconv_block": B3_FUSED_PER_FORWARD},
}


def _int8_layer_shapes(forward, spec, batch: int) -> dict[tuple, dict]:
    """Every distinct Q1/Q2 call of one ``batch`` forward of the w8a8
    ``forward``: {(kind, C_in, C_out, k, stride, padding, H, W): {"module":
    the first module of that shape, "calls": calls of it a forward}}."""
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops

    shapes: dict[tuple, dict] = {}
    handles = []
    for name, m in forward.inner.named_modules():
        if isinstance(m, int8_ops.Int8Conv2d):
            def hook(mod, args, name=name):
                key = (mod.kind, mod.c_in, mod.c_out, mod.kernel_size[0], mod.stride,
                       str(mod.padding), *args[0].shape[1:3])
                shapes.setdefault(key, {"module": name, "calls": 0})["calls"] += 1
            handles.append(m.register_forward_pre_hook(hook))
    try:
        with torch.inference_mode():
            forward(torch.zeros((batch, *spec.input_shape), dtype=torch.uint8, device="cuda"))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return shapes


def _quant_family_phase(spec, seed: int, iters: int, smi: str, gen,
                        int8_records: list[dict]) -> dict:
    """``spec`` (ResNet50 at 224 px or EfficientNet-B3 at 300 px, full width
    and depth, random weights from ``seed``) as v1 float (bf16), v2
    int8-weight-only and v3 int8-w8a8 written by the port's
    ``write_quantized_version`` (v3 calibrated on the card from
    QUANT_CALIB_IMAGES noise images at percentile QUANT_CALIB_PERCENTILE:
    every quantized layer must get a scale).  The three arms' engines serve
    from graphs at BUCKETS; the w8a8 one's warmup gate prints its drift and
    top-1.  If the gate passes: v3 served over msgpack (the main path) must
    launch one Q1 or Q2 per calibrated layer a forward and no other hand
    kernel, each w8a8 bucket graph must replay bit-equal to eager, one
    traced replay must show the Q1/Q2 kernels by name and no library
    convolution beyond the float convolutions left (layers too small to
    quantize).  If it refuses (seeded random weights), the run says so and
    checks that v3 served weight-only.  Either way every distinct Q1/Q2
    shape of the w8a8 forward at batch 16 is held against its plain version
    (max abs difference 0) and timed (``int8-kernel`` lines), and the
    arms' p50 at each bucket are taken in turns.  Adds this family's Q1/Q2
    sums to ``int8_records`` under ``by_model``."""
    import shutil

    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.layers import Conv2dNHWC
    from kubernetes_deep_learning_tpu_torch.ops import int8 as int8_ops
    from kubernetes_deep_learning_tpu_torch.ops import quantize
    from kubernetes_deep_learning_tpu_torch.runtime import InferenceEngine

    t_phase = time.perf_counter()
    per_forward = QUANT_FAMILIES[spec.name]
    out: dict = {"model": spec.name, "expected_per_forward": per_forward}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "versions")
        art.save_artifact(art.version_dir(root, spec.name, 1), spec,
                          init_variables(spec, seed=seed), {"compute_dtype": "bfloat16"})
        v2 = quantize.write_quantized_version(root, spec.name, quantize.SCHEME)
        calib = quantize.representative_images(spec, QUANT_CALIB_IMAGES, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v3 = quantize.write_quantized_version(
            root, spec.name, quantize.SCHEME_W8A8, calib_images=calib,
            percentile=QUANT_CALIB_PERCENTILE, from_version=1)
        out["calibration_s"] = time.perf_counter() - t0
        w8a8 = art.load_artifact(v3)
        out["calibration"] = w8a8.metadata["calibration"]
        if out["calibration"]["layers"] != sum(per_forward.values()):
            _fail(f"quant {spec.name}: calibration scaled {out['calibration']['layers']} "
                  f"layers, expected {sum(per_forward.values())}")
        w3 = os.path.join(tmp, "w8a8")
        shutil.copytree(v3, art.version_dir(w3, spec.name, 1))

        engines = {}
        for tag, vdir in (("w8a8", v3), ("weight-only", v2),
                          ("float", art.version_dir(root, spec.name, 1))):
            engines[tag] = InferenceEngine(art.load_artifact(vdir), buckets=BUCKETS,
                                           device="cuda")
            engines[tag].warmup()
        e3 = engines["w8a8"]
        passed = e3.quantization_active == quantize.SCHEME_W8A8
        out["gate"] = dict(passed=passed, drift=e3.quant_gate_drift, top1=e3.quant_gate_top1,
                           tol=quantize.resolve_quant_tol(), top1_min=quantize.GATE_TOP1)
        print("quant-family-gate:", json.dumps({"model": spec.name, **out["gate"],
                                                "card": smi}), flush=True)
        if not passed:
            print(f"quant {spec.name}: the warmup gate REFUSED w8a8 on seeded random weights "
                  f"(drift {e3.quant_gate_drift}, top-1 {e3.quant_gate_top1}); the engine "
                  "serves weight-only and the w8a8 forward is checked directly", flush=True)
        forward = e3._forward if passed else quantize.build_w8a8_forward(spec, w8a8.variables)
        layers = [m for m in forward.modules() if isinstance(m, int8_ops.Int8Conv2d)]
        kinds = {k: sum(m.kind == k.removeprefix("int8_") for m in layers) for k in per_forward}
        if kinds != per_forward:
            _fail(f"quant {spec.name}: the w8a8 forward holds {kinds} int8 layers, "
                  f"expected {per_forward}")
        float_convs = sum(isinstance(m, Conv2dNHWC) for m in forward.modules())
        out["float_convs_left"] = float_convs

        # --- the main path: v3 served over msgpack ---
        rng = np.random.default_rng(seed + 31)
        batches = [rng.integers(0, 256, (n, *spec.input_shape), np.uint8) for n in REQUESTS]
        active = quantize.SCHEME_W8A8 if passed else quantize.SCHEME
        replies, launches, _ = _serve_checked(
            w3, spec, batches, scheme=quantize.SCHEME_W8A8, active=active,
            per_forward=per_forward if passed else QUANT_FAMILY_WEIGHT_ONLY[spec.name],
            counters=_kernel_modules())
        out["launches"] = launches
        for imgs, got in zip(batches, replies):
            if not np.array_equal(got, e3.predict(imgs)):
                _fail(f"quant {spec.name}: a reply differs from the same artifact's engine")

        # --- w8a8 graphs against eager, the trace, against weight-only ---
        if passed:
            out["graphs"] = _graph_check(e3, f"{spec.name}-w8a8", seed + 32)
            if not out["graphs"]["all_bit_equal"]:
                _fail(f"quant {spec.name}: a w8a8 bucket graph is not bit-equal to eager: "
                      f"{out['graphs']}")
            trace = {f"int8_{k.removeprefix('int8_')}_kernel": v for k, v in per_forward.items()}
            trace["int8_codes_kernel"] = per_forward["int8_conv"]  # Q1's quantize pass
            out["trace_launches"] = _trace_check(e3, f"{spec.name}-w8a8", seed + 33, trace)
            library = out["trace_launches"]["library_convs"]
            if sum(library.values()) > float_convs:
                _fail(f"quant {spec.name}: one replay ran {sum(library.values())} library "
                      f"convolution kernels for {float_convs} float convolutions: {library}")
            grid = _grid_images(spec, QUANT_GRID, seed + 34)
            got, ref = e3.predict(grid), engines["weight-only"].predict(grid)
            out["grid"] = dict(images=QUANT_GRID, top1=float((got.argmax(-1) ==
                                                              ref.argmax(-1)).mean()),
                               drift=float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)))

        # --- every distinct Q1/Q2 shape against its plain version ---
        shapes = _int8_layer_shapes(forward, spec, 16)
        sums = {name: dict(launches=launches.get(name, 0), max_abs_err=0.0, ms=0.0,
                           graph_ms=0.0, plain_ms=0.0, bound_ms=0.0, shapes=0,
                           **_int8_extra_sums(name))
                for name in per_forward}
        for key, info in shapes.items():
            layer = forward.inner.get_submodule(info["module"])
            name = f"int8_{layer.kind}"
            t = _int8_case(layer, 16, key[-2], gen, iters)
            print("int8-kernel:", json.dumps({"name": name, "model": spec.name,
                                              "module": info["module"], "batch": 16,
                                              "per_forward": info["calls"], **t, "card": smi}),
                  flush=True)
            rec = sums[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], t["max_abs_err"])
            rec["shapes"] += 1
            for k in ("ms", "graph_ms", "plain_ms", "bound_ms"):
                rec[k] += info["calls"] * t[k]
            _add_int8_extra(rec, t, info["calls"])
        for rec in sums.values():
            _finish_int8_extra(rec)
        calls = {n: sum(i["calls"] for k, i in shapes.items() if f"int8_{k[0]}" == n)
                 for n in per_forward}
        if calls != per_forward:
            _fail(f"quant {spec.name}: a forward called {calls} int8 layers, expected "
                  f"{per_forward}")
        for rec in int8_records:
            rec.setdefault("by_model", {})[spec.name] = {
                **sums[rec["name"]], "per": "one bucket-16 forward's calls, summed"}
        out["kernels"] = sums

        # --- p50 of the three arms at each bucket, in turns ---
        lat: dict = {tag: {b: [] for b in BUCKETS} for tag in engines}
        for b in BUCKETS:
            imgs = rng.integers(0, 256, (b, *spec.input_shape), np.uint8)
            for e in engines.values():
                e.predict(imgs)
            for _ in range(iters):
                for tag, e in engines.items():
                    t0 = time.perf_counter()
                    e.predict(imgs)
                    lat[tag][b].append((time.perf_counter() - t0) * 1e3)
        out["p50_ms"] = {tag: {str(b): float(np.median(v)) for b, v in d.items()}
                         for tag, d in lat.items()}
        for e in engines.values():
            e.close()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# --- the lifecycle from a Keras .h5 to the client's reply (ROADMAP A14, A6h2) ---

EXPORT_CALIBRATE = 8          # noise images kdlt-torch-export --calibrate runs (percentile 100)
EXPORT_BUCKETS = "1,4,16"
EXPORT_FIXTURE = "q95_420_299x299.jpg"  # the client's image and verify-golden's
EXPORT_GOLDEN_TOL = 1e-3      # verify-golden's printed scores (3 decimals) vs exact f32
EXPORT_SWAP_S = 180.0         # the watcher's load and warmup of the w8a8 version
EXPORT_GOLDEN_LEAD = 8.0      # the raised pants logit's lead (the reference's golden: 6.7)
H5_LEAF_K, H5_INTERNAL_K = 4, 16  # a superblock-0 file's group node K values (HDF5's)
_H5_UNDEF = (1 << 64) - 1


def _write_h5(path: str, tree: dict) -> int:
    """Write ``tree`` (nested dicts are groups, float arrays datasets) as the
    HDF5 subset ``h5py.File(path, "w")`` writes, without ``h5py``:
    superblock 0, 8-byte offsets and lengths, symbol-table groups (a local
    heap, one B-tree leaf node, a symbol-table node for every 8 links),
    version-1 object headers, contiguous little-endian datasets.  A group
    holds at most 256 links (one B-tree leaf).  Returns the file's size."""
    import struct

    def u(fmt: str, v: int) -> bytes:
        return struct.pack("<" + fmt, v)

    snod_size = 8 + 2 * H5_LEAF_K * 40
    tree_size = 8 + 16 + (2 * H5_INTERNAL_K + 1) * 8 + 2 * H5_INTERNAL_K * 8
    out = bytearray(96)  # the superblock, written last

    def pad8(b: bytes) -> bytes:
        return b + bytes(-len(b) % 8)

    def message(kind: int, body: bytes) -> bytes:
        body = pad8(body)
        return u("H", kind) + u("H", len(body)) + bytes(4) + body

    def header(messages: list[bytes]) -> bytes:
        data = b"".join(messages)
        return (u("B", 1) + bytes(1) + u("H", len(messages)) + u("I", 1) + u("I", len(data))
                + bytes(4) + data)

    def alloc(n: int) -> int:
        pos = len(out)
        out.extend(bytes(n + (-n % 8)))
        return pos

    def put(pos: int, b: bytes) -> None:
        out[pos:pos + len(b)] = b

    def dataset(arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr, np.dtype(arr.dtype).newbyteorder("<"))
        size = arr.dtype.itemsize
        if arr.dtype.kind != "f" or size not in (2, 4, 8):
            raise ValueError(f"no writer for {arr.dtype}")
        exp_loc, exp_size, mant, bias = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127),
                                         8: (52, 11, 52, 1023)}[size]
        dtype = (u("B", 0x11) + u("B", 0x20) + u("B", 8 * size - 1) + bytes(1) + u("I", size)
                 + u("H", 0) + u("H", 8 * size) + u("B", exp_loc) + u("B", exp_size) + bytes(1)
                 + u("B", mant) + u("I", bias))
        space = u("B", 1) + u("B", arr.ndim) + bytes(6) + b"".join(u("Q", d) for d in arr.shape)
        msgs = [message(0x0001, space), message(0x0003, dtype), message(0x0008, bytes(18))]
        head = alloc(len(header(msgs)))
        data = alloc(arr.nbytes) if arr.nbytes else _H5_UNDEF
        msgs[2] = message(0x0008, u("B", 3) + u("B", 1) + u("Q", data) + u("Q", arr.nbytes))
        put(head, header(msgs))
        if arr.nbytes:
            put(data, arr.tobytes())
        return head

    def group(members: dict) -> tuple[int, int, int]:
        names = sorted(members, key=str.encode)
        if len(names) > 4 * H5_INTERNAL_K * H5_LEAF_K:
            raise ValueError(f"a group of {len(names)} links needs a deeper B-tree")
        heap_data, offsets = bytearray(8), []  # offset 0: the empty name
        for n in names:
            offsets.append(len(heap_data))
            heap_data += pad8(n.encode() + b"\x00")
        stab = [message(0x0011, bytes(16))]
        head, heap, heap_seg, btree = (alloc(len(header(stab))), alloc(32), alloc(len(heap_data)),
                                       alloc(tree_size))
        nodes = [range(i, min(i + 2 * H5_LEAF_K, len(names)))
                 for i in range(0, len(names), 2 * H5_LEAF_K)]
        snods = [alloc(snod_size) for _ in nodes]
        put(head, header([message(0x0011, u("Q", btree) + u("Q", heap))]))
        # The free list's head 1 is HDF5's "no free block".
        put(heap, b"HEAP" + bytes(4) + u("Q", len(heap_data)) + u("Q", 1) + u("Q", heap_seg))
        put(heap_seg, bytes(heap_data))
        # Key i+1 of the B-tree node: the heap offset of node i's last name.
        put(btree, b"TREE" + bytes(2) + u("H", len(nodes)) + u("Q", _H5_UNDEF) + u("Q", _H5_UNDEF)
            + u("Q", 0) + b"".join(u("Q", s) + u("Q", offsets[r[-1]]) for s, r in zip(snods, nodes)))
        for snod, members_of in zip(snods, nodes):
            entries = b""
            for i in members_of:
                child = members[names[i]]
                if isinstance(child, dict):  # cache type 1: the child's B-tree and heap
                    addr, c_btree, c_heap = group(child)
                    entries += (u("Q", offsets[i]) + u("Q", addr) + u("I", 1) + bytes(4)
                                + u("Q", c_btree) + u("Q", c_heap))
                else:
                    entries += u("Q", offsets[i]) + u("Q", dataset(child)) + bytes(24)
            put(snod, b"SNOD" + u("B", 1) + bytes(1) + u("H", len(members_of)) + entries)
        return head, btree, heap

    root, btree, heap = group(tree)
    size = len(out)
    put(0, b"\x89HDF\r\n\x1a\n" + bytes(5) + u("B", 8) + u("B", 8) + bytes(1) + u("H", H5_LEAF_K)
        + u("H", H5_INTERNAL_K) + bytes(4) + u("Q", 0) + u("Q", _H5_UNDEF) + u("Q", size)
        + u("Q", _H5_UNDEF) + u("Q", 0) + u("Q", root) + u("I", 1) + bytes(4) + u("Q", btree)
        + u("Q", heap))
    with open(path, "wb") as f:
        f.write(out)
    return size


def _keras_tree(variables: dict) -> dict:
    """Xception's flax tree in the reference .h5's layout:
    ``model_weights/xception/<layer>/<layer>/<weight>:0``, with the layers
    Keras auto-names -- the four residual convs (``conv2d`` ..
    ``conv2d_3``), their BatchNorms and the head's Dense layers
    (``dense_5`` ..., beside the base model) -- named as Keras names them."""
    params, stats = variables["params"], variables["batch_stats"]
    residual = {"block2_res": 0, "block3_res": 1, "block4_res": 2, "block13_res": 3}

    def keras(base: str, n: int) -> str:
        return base if n == 0 else f"{base}_{n}"

    def bn(name: str, p: dict) -> dict:
        return {"gamma:0": p["scale"], "beta:0": p["bias"], "moving_mean:0": stats[name]["mean"],
                "moving_variance:0": stats[name]["var"]}

    base: dict = {}
    for name, p in params.items():
        if name == "head":
            continue
        if name.endswith("_res_conv"):
            layer, weights = keras("conv2d", residual[name[:-5]]), {"kernel:0": p["kernel"]}
        elif name.endswith("_res_bn"):
            layer, weights = keras("batch_normalization", residual[name[:-3]]), bn(name, p)
        elif name.endswith("_bn"):
            layer, weights = name, bn(name, p)
        elif "sepconv" in name:
            layer, weights = name, {
                "depthwise_kernel:0": np.transpose(p["depthwise"]["kernel"], (0, 1, 3, 2)),
                "pointwise_kernel:0": p["pointwise"]["kernel"]}
        else:
            layer, weights = name, {"kernel:0": p["kernel"]}
        base[layer] = {layer: weights}
    tree = {"xception": base}
    head = params["head"]
    hidden = sorted(k for k in head if k.startswith("hidden_"))
    for i, k in enumerate([*hidden, "logits"]):
        tree[f"dense_{5 + i}"] = {f"dense_{5 + i}": {"kernel:0": head[k]["kernel"],
                                                     "bias:0": head[k]["bias"]}}
    return {"model_weights": tree}


def _pants_leads(spec, variables: dict, exact, lead: float) -> dict:
    """A copy of ``variables`` with the head's pants bias raised so that,
    on the image whose exact logits are ``exact``, pants leads every other
    label by ``lead``: a seeded model whose golden check can pass."""
    i = list(spec.labels).index("pants")
    others = max(float(v) for j, v in enumerate(exact) if j != i)

    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) else np.array(t)

    out = copy(variables)
    out["params"]["head"]["logits"]["bias"][i] += np.float32(others + lead - float(exact[i]))
    return out


def _golden_both_checks(h5: str, image: str, want: dict, device: str) -> tuple[int, str]:
    """``kdlt-torch-verify-golden --weights h5 --image image`` in this
    process against ``want`` as its golden dict: the exit code and what it
    printed."""
    import contextlib
    import io

    from kubernetes_deep_learning_tpu_torch import golden

    saved, golden.GOLDEN_LOGITS = golden.GOLDEN_LOGITS, want
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            code = golden.main(["--weights", h5, "--image", image, "--device", device])
    finally:
        golden.GOLDEN_LOGITS = saved
    return code, printed.getvalue()


def _flat_leaves(tree: dict, path: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat_leaves(v, (*path, k)) if isinstance(v, dict) else {(*path, k): v})
    return out


def _cli_start(module: str, args: list) -> tuple[subprocess.Popen, float]:
    """Start ``python -m kubernetes_deep_learning_tpu_torch.<module>`` (a
    console script's module) from the checkout."""
    return subprocess.Popen(
        [sys.executable, "-m", f"kubernetes_deep_learning_tpu_torch.{module}", *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))), time.perf_counter()


def _cli_finish(started: tuple[subprocess.Popen, float], *, timeout: float,
                expect: int = 0) -> tuple[str, float]:
    """(stdout, seconds) of a ``_cli_start``-ed process; any other exit code
    than ``expect`` fails the run."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if proc.returncode != expect:
        _fail(f"export: {' '.join(proc.args[2:4])} exited {proc.returncode}, not {expect}:\n"
              f"{out[-2000:]}\n{err[-4000:]}")
    return out, time.perf_counter() - t0


def _cli(module: str, args: list, *, timeout: float, expect: int = 0) -> tuple[str, float]:
    return _cli_finish(_cli_start(module, args), timeout=timeout, expect=expect)


def _native_metrics(port: int) -> tuple[float, dict[str, float]]:
    """A port server's ``kdlt_native_builds`` and ``kdlt_kernel_launches``
    by kernel, off its /metrics."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    builds = re.search(r"^kdlt_native_builds (\S+)$", text, re.M)
    launches = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^kdlt_kernel_launches\{kernel="(\w+)"\} (\S+)$', text, re.M)}
    return (float(builds.group(1)) if builds else float("nan")), launches


def _wait_ready(port: int, what: str, log_path: str, timeout: float) -> float:
    t0 = time.perf_counter()
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz", timeout=5) as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > timeout:
            with open(log_path) as fh:
                _fail(f"export: the {what} is not ready after {timeout} s: {fh.read()[-3000:]}")
        time.sleep(0.1)


def _export_phase(spec, seed: int, smi: str, *, per_forward: dict) -> dict:
    """The reference's lifecycle, end to end, each step through its console
    script's module (ROADMAP A14, A6h2): ``spec`` (clothing-model, full
    width) seeded from ``seed`` and written as a Keras-layout .h5 by
    ``_write_h5`` (no h5py here), imported by ``h5lite`` bit-equal;
    ``kdlt-torch-export --weights --calibrate 8`` (v1 bf16, v2 w8a8);
    ``kdlt-torch-inspect --root``; ``kdlt-torch-warm`` into a fresh build
    directory; ``kdlt-torch-model-server`` booted against it (v1 alone under
    a root of its own, v2 linked in later for the watcher to swap to) and
    ``kdlt-torch-gateway`` in front; ``kdlt-torch-client`` on a committed
    JPEG over a local http.server, its scores bit-equal to the tensor wire's
    for the same pixels, with 8 K1 + 2 K2 launches a forward on v1 and 39 Q1
    + 29 Q2 (no K1/K2) on v2, read off the server's ``kdlt_kernel_launches``;
    the server compiled nothing (``kdlt_native_builds`` 0 and its boot
    line); ``kdlt-torch-verify-golden`` exits 1 (seeded weights are not the
    golden ones) with scores within 1e-3 of the exact f32 forward."""
    from kubernetes_deep_learning_tpu_torch.models import build_forward, init_variables
    from kubernetes_deep_learning_tpu_torch.models.keras_import import load_keras_h5
    from kubernetes_deep_learning_tpu_torch.ops import preprocess
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    name, labels = spec.name, list(spec.labels)
    out: dict = {"model": name, "card": smi}
    secs: dict = {}
    procs: list = []
    with tempfile.TemporaryDirectory() as root:
        try:
            # --- the .h5: written and read back without h5py ---
            variables = init_variables(spec, seed=seed)
            h5 = os.path.join(root, f"{name}.h5")
            t0 = time.perf_counter()
            out["h5_bytes"] = _write_h5(h5, _keras_tree(variables))
            secs["write_h5"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            imported = load_keras_h5(spec, h5)
            secs["import"] = time.perf_counter() - t0
            want, got = _flat_leaves(variables), _flat_leaves(imported)
            unequal = sorted(set(want) ^ set(got)) + [
                k for k in want.keys() & got.keys()
                if got[k].dtype != np.float32 or got[k].shape != want[k].shape
                or got[k].tobytes() != np.ascontiguousarray(want[k]).tobytes()]
            if unequal:
                _fail(f"export: the .h5 imports other leaves than were written: {unequal[:5]}")
            out["import"] = {"leaves": len(got), "bit_equal": True}
            # --- kdlt-torch-export: v1 (bf16 compute), v2 (w8a8, calibrated on the card) ---
            models = os.path.join(root, "models")
            text, secs["export_cli"] = _cli(
                "export.exporter", ["--model", name, "--weights", h5, "--output", models,
                                    "--calibrate", EXPORT_CALIBRATE, "--calibrate-percentile",
                                    100, "--device", "cuda"], timeout=600)
            for step, pattern in (("export", r"^exported .* in (\S+) s$"),
                                  ("calibrate", r"^calibrated .* in (\S+) s$")):
                found = re.search(pattern, text, re.M)
                if not found:
                    _fail(f"export: no {step} line in kdlt-torch-export's output: {text[-1000:]}")
                secs[step] = float(found.group(1))
            meta = {}
            for v in (1, 2):
                with open(os.path.join(models, name, str(v), "metadata.json")) as fh:
                    meta[v] = json.load(fh)
            if (meta[1].get("compute_dtype"), meta[1].get("init"), meta[2].get("quantization")) \
                    != ("bfloat16", "keras-h5", "int8-w8a8"):
                _fail(f"export: unexpected metadata {meta}")
            # --- kdlt-torch-inspect ---
            text, secs["inspect"] = _cli("export.inspect", ["--root", models], timeout=300)
            for need in (f"Artifact: {os.path.join(models, name, '1')}",
                         f"Artifact: {os.path.join(models, name, '2')}",
                         "meta.quantization: int8-w8a8", "params-only"):
                if need not in text:
                    _fail(f"export: kdlt-torch-inspect printed no {need!r}: {text[-2000:]}")
            # --- kdlt-torch-warm: the libraries into a fresh directory, v2 warmed ---
            build = os.path.join(root, "build")
            text, secs["warm"] = _cli("export.warm", ["--models", models, "--build-dir", build,
                                                      "--buckets", EXPORT_BUCKETS, "--json"],
                                      timeout=900)
            report = json.loads(text[text.index("{"):])
            model = report["models"].get(name, {})
            if (model.get("version") != 2 or "error" in model or report["failed_libraries"]
                    or not all(r.get("built") for r in report["libraries"].values())):
                _fail(f"export: kdlt-torch-warm: {report}")
            out["warm"] = {"libraries_s": {k: r["seconds"] for k, r in report["libraries"].items()},
                           "model_s": model["seconds"], "built": report["built"]}
            # --- the image host, the server (v1 alone) and the gateway ---
            img_dir = os.path.join(root, "images")
            os.makedirs(img_dir)
            with open(os.path.join(GW_FIXTURES, EXPORT_FIXTURE), "rb") as fh:
                jpeg = fh.read()
            with open(os.path.join(img_dir, EXPORT_FIXTURE), "wb") as fh:
                fh.write(jpeg)
            img_port, port, gw_port = _free_port(), _free_port(), _free_port()
            procs.append(subprocess.Popen([sys.executable, "-c", GW_IMAGE_SERVER, str(img_port),
                                           img_dir], stdout=subprocess.DEVNULL,
                                          stderr=subprocess.DEVNULL))
            serve = os.path.join(root, "serve")
            os.makedirs(os.path.join(serve, name))
            os.symlink(os.path.join(models, name, "1"), os.path.join(serve, name, "1"))
            logs = {k: os.path.join(root, f"{k}.log") for k in ("server", "gateway")}
            here = os.path.dirname(os.path.abspath(__file__))
            # verify-golden runs beside the server's boot (its own engines,
            # on the default build directory): exit 1, read at the end.
            fixture = os.path.join(img_dir, EXPORT_FIXTURE)
            golden_run = _cli_start("golden", ["--weights", h5, "--image", fixture,
                                               "--device", "cuda"])
            procs.append(golden_run[0])
            t0 = time.perf_counter()
            with open(logs["server"], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.model_server",
                     "--model-root", serve, "--port", str(port), "--buckets", EXPORT_BUCKETS,
                     "--device", "cuda", "--watch-interval", "0.5", "--no-request-log"],
                    env={**os.environ, "KDLT_TORCH_BUILD_DIR": build}, stdout=log,
                    stderr=subprocess.STDOUT, cwd=here))
            with open(logs["gateway"], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "kubernetes_deep_learning_tpu_torch.serving.gateway",
                     "--serving-host", f"127.0.0.1:{port}", "--model", name, "--port",
                     str(gw_port), "--no-request-log"],
                    stdout=log, stderr=subprocess.STDOUT, cwd=here))
            secs["boot"] = _wait_ready(port, "model server", logs["server"], 300)
            _wait_ready(gw_port, "gateway", logs["gateway"], 120)
            pixels = preprocess.preprocess_bytes(jpeg, spec.input_shape[:2],
                                                 filter=spec.resize_filter)
            server_url = f"http://127.0.0.1:{port}/v1/models/{name}:predict"

            def served(version: int, expect: dict, *flags) -> dict:
                """One kdlt-torch-client request through the gateway and one on
                the tensor wire direct: equal scores, the launches of two
                forwards."""
                _, before = _native_metrics(port)
                text, client_s = _cli("serving.client", [
                    "--gateway", f"http://127.0.0.1:{gw_port}", "--image-url",
                    f"http://127.0.0.1:{img_port}/{EXPORT_FIXTURE}", *flags], timeout=120)
                scores = json.loads(text)
                direct = _post(server_url, pixels[None], "msgpack")[0][0]
                _, after = _native_metrics(port)
                launches = {k: after[k] - before.get(k, 0.0) for k in after}
                want = {k: 2 * n for k, n in expect.items()}
                if (list(scores) != labels or scores != dict(zip(labels, map(float, direct)))
                        or not np.isfinite(list(scores.values())).all()):
                    _fail(f"export: v{version}: the client printed {scores}, the tensor wire "
                          f"gave {direct.tolist()}")
                if {k: v for k, v in launches.items() if v or k in want} != want:
                    _fail(f"export: v{version}: launches {launches} for 2 forwards, want {want}")
                return {"client_s": client_s, "bit_equal": True, "launches": launches,
                        "top1": max(scores, key=scores.get)}

            out["v1"] = served(1, per_forward)
            # --- v2 joins the root: the watcher swaps to the w8a8 version ---
            t0 = time.perf_counter()
            os.symlink(os.path.join(models, name, "2"), os.path.join(serve, name, "2"))
            while True:
                _, status, _ = _http_json(port, f"/v1/models/{name}:status")
                if status.get("version") == 2 and status.get("ready"):
                    break
                if time.perf_counter() - t0 > EXPORT_SWAP_S:
                    _fail(f"export: the server did not swap to v2: {status}")
                time.sleep(0.2)
            secs["swap"] = time.perf_counter() - t0
            out["v2"] = served(2, QUANT_PER_FORWARD, "--cache-bust")
            builds, _ = _native_metrics(port)
            with open(logs["server"]) as fh:
                boot = [ln for ln in fh.read().splitlines() if "native libraries from" in ln]
            if builds != 0 or not boot or f"from {build}: 0 built here" not in boot[0]:
                _fail(f"export: the warmed server compiled: kdlt_native_builds {builds}, {boot}")
            out["server"] = {"native_builds": builds,
                             "boot_line": boot[0][boot[0].index("native libraries"):]}
            # --- kdlt-torch-verify-golden: exit 1, scores at the exact f32 forward ---
            text, secs["verify_golden"] = _cli_finish(golden_run, timeout=300, expect=1)
            found = re.search(r"^scores: (\{.*\})$", text, re.M)
            if not found:
                _fail(f"export: verify-golden printed no scores: {text[-1000:]}")
            import ast

            golden = ast.literal_eval(found.group(1))
            forward = build_forward(spec, from_jax_variables(variables), torch.float32,
                                    fast=False, device="cuda")
            with torch.inference_mode():
                exact = forward(torch.from_numpy(pixels[None]).cuda())[0].cpu().numpy()
            err = max(abs(golden[k] - float(v)) for k, v in zip(labels, exact))
            if sorted(golden) != sorted(labels) or not err <= EXPORT_GOLDEN_TOL:
                _fail(f"export: verify-golden scores {golden} vs exact f32 {exact.tolist()}: "
                      f"{err} > {EXPORT_GOLDEN_TOL}")
            out["verify_golden"] = {"exit_code": 1, "max_abs_err": err, "tol": EXPORT_GOLDEN_TOL}
            # --- its served check: both checks pass on a model with a known golden ---
            t0 = time.perf_counter()
            raised = _pants_leads(spec, variables, exact, EXPORT_GOLDEN_LEAD)
            golden_h5 = os.path.join(root, "golden.h5")
            _write_h5(golden_h5, _keras_tree(raised))
            forward = build_forward(spec, from_jax_variables(raised), torch.float32,
                                    fast=False, device="cuda")
            with torch.inference_mode():
                want = dict(zip(labels, map(float, forward(
                    torch.from_numpy(pixels[None]).cuda())[0].cpu().numpy())))
            for m in _kernel_modules():
                m.reset_launch_counts()
            code, text = _golden_both_checks(golden_h5, fixture, want, "cuda")
            launches = {k: v for m in _kernel_modules() for k, v in m.launch_counts().items()}
            found = re.search(r"^served-config scores: (\{.*\})$", text, re.M)
            if code != 0 or not found:
                _fail(f"export: verify-golden against its own exact scores exited {code}: {text}")
            served_scores = ast.literal_eval(found.group(1))
            served_err = max(abs(served_scores[k] - want[k]) for k in labels)
            # The served engine is fresh: its bucket-1 graph's capture runs one
            # forward before it, and the replay is credited one more.
            want_launches = {k: 0 for k in launches} | {k: 2 * v for k, v in per_forward.items()}
            if launches != want_launches:
                _fail(f"export: verify-golden's two checks launched {launches}, "
                      f"want {want_launches}")
            secs["verify_golden_served"] = time.perf_counter() - t0
            out["verify_golden"]["served"] = {
                "exit_code": 0, "pants_lead": EXPORT_GOLDEN_LEAD, "max_abs_err": served_err,
                "tol": 0.2, "launches": launches}
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    out["seconds"] = secs
    return out


# The generative lane (ROADMAP A12).  JAX's five mixed-bucket, mixed-budget
# requests (tests/test_decode.py), prompts for the teacher-forced graph
# check (one in each prefill bucket, two in the largest), the churn run's
# slots, and the timing arms' load.
GEN_REQUESTS = (("short", 10), ("a much longer prompt string", 4), ("mid-size prompt", 8),
                ("x", 12), ("long-ish prompt here", 6))
GEN_FORCED_PROMPTS = ("short", "p" * 20, "q" * 40, "r" * 60)
GEN_FORCED_STEPS = 60
GEN_CACHE_TOL = 1e-5  # relative, a graph's cache against the eager function's
GEN_MARGIN = 1e-4     # top-2 logit margin above which a graph's token must be eager's
GEN_CHURN_SLOTS = 16
GEN_CHURN_STAGGER_S = 0.003  # request i is submitted i x this after the first
GEN_LOAD = 32
GEN_ARMS = (True, False, False, True)  # continuous, static, in turns
GEN_REPLAYS = 200


def _gen_requests(n: int, seed: int) -> list[tuple[str, int]]:
    """``n`` (prompt, max_new_tokens): 1-62 lowercase bytes (every prefill
    bucket), budgets 4-40."""
    rng = np.random.default_rng(seed)
    return [("".join(map(chr, rng.integers(97, 123, int(rng.integers(1, 63))))),
             int(rng.integers(4, 41))) for _ in range(n)]


def _gen_pages_back(engine, where: str) -> None:
    if (engine.pages_in_use or engine.active_slots or engine._slot_pages
            or sorted(engine._free_pages) != list(range(1, engine.num_pages))
            or sorted(engine._free_slots) != list(range(engine.max_slots))):
        _fail(f"generate: pages or slots not all returned after {where}: "
              f"{engine.pages_in_use} pages in use, {engine.active_slots} slots active")


def _gen_graph_check(engine) -> dict:
    """Every graph against the eager function on the same inputs, teacher-
    forced: prompts in every bucket prefilled into all slots, then
    ``GEN_FORCED_STEPS`` steps, each slot fed eager's greedy token.  After
    every replay the cache (the trash page aside: duplicate writes land
    there in no fixed order) within GEN_CACHE_TOL relative of the eager
    cache, and the graph's token eager's wherever eager's top-2 margin is
    above GEN_MARGIN."""
    from kubernetes_deep_learning_tpu_torch.runtime.decode import STEP, encode_prompt

    cache = engine.cache.clone()
    out = {"worst_cache_rel": 0.0, "compared": 0, "under_margin": 0, "programs": set()}

    def compare(key, packed: np.ndarray, dispatch, rows: list[int]) -> np.ndarray:
        logits = engine.logits(key, torch.from_numpy(packed).to(engine.device), cache)
        toks = np.atleast_1d(engine.materialize(dispatch()))
        ref, got = cache[:, :, 1:], engine.cache[:, :, 1:]
        rel = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
        out["worst_cache_rel"] = max(out["worst_cache_rel"], rel)
        if not rel <= GEN_CACHE_TOL:
            _fail(f"generate: the {key} graph's cache is {rel:.3g} from eager's "
                  f"(tolerance {GEN_CACHE_TOL})")
        lg = logits.reshape(-1, logits.shape[-1])[rows]
        top2 = lg.topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]).cpu().numpy() > GEN_MARGIN
        want = lg.argmax(dim=-1).cpu().numpy()
        if (toks[rows][wide] != want[wide]).any():
            _fail(f"generate: the {key} graph's tokens {toks[rows].tolist()} are not eager's "
                  f"{want.tolist()} above the {GEN_MARGIN} margin")
        out["compared"] += int(wide.sum())
        out["under_margin"] += int((~wide).sum())
        out["programs"].add(key)
        return want

    slots = []
    for prompt in GEN_FORCED_PROMPTS:
        tokens = encode_prompt(prompt)
        slot = engine.acquire_slot(len(tokens) + GEN_FORCED_STEPS + 1)
        bucket, packed = engine.prefill_inputs(slot, tokens)
        first = compare(bucket, packed, lambda: engine.prefill(slot, tokens), [0])
        engine.seed_token(slot, int(first[0]))
        slots.append(slot)
    for _ in range(GEN_FORCED_STEPS):
        want = compare(STEP, engine.step_inputs(), engine.step_async, slots)
        for slot, tok in zip(slots, want):
            engine.seed_token(slot, int(tok))
    for slot in slots:
        engine.release_slot(slot)
    if out["programs"] != {*engine.prompt_buckets, STEP}:
        _fail(f"generate: the graph check ran {out['programs']}, not every program")
    out["programs"] = len(out["programs"])
    return out


def _gen_batch_vs_solo(engine, requests, stagger_s: float) -> dict:
    """``requests`` on the continuous scheduler, submitted ``stagger_s``
    apart from threads of their own (so members join and retire around one
    another), then each again alone through ``decode_solo``: every stream
    bit-identical.  The most slots seen active at once is sampled."""
    import threading

    from kubernetes_deep_learning_tpu_torch.runtime.decode import DecodeScheduler
    from kubernetes_deep_learning_tpu_torch.utils import metrics as metrics_lib

    registry = metrics_lib.Registry()
    sched = DecodeScheduler(engine, continuous=True, registry=registry)
    sched.start()
    streamed: dict[int, list[int]] = {}
    busiest = [0]
    running = True

    def drive(i: int, prompt: str, budget: int) -> None:
        time.sleep(i * stagger_s)
        gen = sched.submit(prompt, budget, rid=f"gen-{i}")
        streamed[i] = [ev[2] for ev in gen.iter_events(timeout_s=60.0) if ev[0] == "token"]

    def sample() -> None:
        while running:
            busiest[0] = max(busiest[0], engine.active_slots)
            time.sleep(0.0005)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    threads = [threading.Thread(target=drive, args=(i, p, n), daemon=True)
               for i, (p, n) in enumerate(requests)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    wall = time.perf_counter() - t0
    running = False
    sampler.join(timeout=5.0)
    sched.close()
    if any(t.is_alive() for t in threads) or sorted(streamed) != list(range(len(requests))):
        _fail(f"generate: {len(requests) - len(streamed)} of {len(requests)} streams on "
              f"{engine.max_slots} slots never finished")
    _gen_pages_back(engine, f"{len(requests)} requests on {engine.max_slots} slots")
    diverged = [i for i, (p, n) in enumerate(requests) if streamed[i] != engine.decode_solo(p, n)]
    if diverged:
        _fail(f"generate: on {engine.max_slots} slots, streams {diverged} of {len(requests)} "
              "are not bit-identical to decode_solo")
    _gen_pages_back(engine, "decode_solo")
    steps = metrics_lib.decode_metrics(registry, engine.model)["steps"].value
    return {"requests": len(requests), "tokens": sum(map(len, streamed.values())),
            "steps": int(steps), "max_active_slots": busiest[0], "seconds": wall,
            "bit_identical_to_solo": True}


def _gen_wire_check(root: str, prompt: str, budget: int, device: str) -> dict:
    """The port's model server with the lane on (``decode=True`` on
    ``device``; a stub image model beside it) behind the port's gateway,
    read by the port's client."""
    from kubernetes_deep_learning_tpu_torch.export import artifact as art
    from kubernetes_deep_learning_tpu_torch.modelspec import CLOTHING_MODEL, ModelSpec
    from kubernetes_deep_learning_tpu_torch.runtime.stub import StubEngine
    from kubernetes_deep_learning_tpu_torch.serving import client as client_lib
    from kubernetes_deep_learning_tpu_torch.serving.gateway import Gateway
    from kubernetes_deep_learning_tpu_torch.serving.model_server import ModelServer

    spec = ModelSpec(name="gen-stub", family="xception", input_shape=(96, 96, 3),
                     labels=CLOTHING_MODEL.labels, preprocessing="tf", resize_filter="nearest")
    art.save_artifact(art.version_dir(root, spec.name, 1), spec, {"params": {}}, {})
    out: dict = {}
    server = ModelServer(root, port=0, buckets=(1,), device=device, decode=True,
                         engine_factory=lambda a, **k: StubEngine(a, **k))
    try:
        server.start()
        t0 = time.perf_counter()
        server.warmup()
        out["server_warmup_s"] = time.perf_counter() - t0
        lane = server.generate
        if lane.engine.device.type != device or lane.engine.graphs_captured != 4:
            _fail(f"generate: the server's lane is on {lane.engine.device} with "
                  f"{lane.engine.graphs_captured} graphs, not on {device} with 4")
        gw = Gateway(serving_host=f"127.0.0.1:{server.port}", model=spec.name, port=0)
        gw.start()
        try:
            base = f"http://127.0.0.1:{gw.port}"
            stats: dict = {}
            t0 = time.perf_counter()
            events = list(client_lib.generate_stream(base, prompt, max_new_tokens=budget,
                                                     stats=stats))
            out["stream_s"] = time.perf_counter() - t0
            done = events[-1] if events else {}
            if not done.get("done") or done.get("tokens") != len(events) - 1:
                _fail(f"generate: the client's stream ended without its done event: {events[-2:]}")
            reply = client_lib.request(
                "POST", f"{base}/generate",
                json.dumps({"prompt": prompt, "max_new_tokens": budget, "stream": False}).encode(),
                {"Content-Type": "application/json"}, timeout=60)
            if reply.status_code != 200 or reply.json()["text"] != done["text"]:
                _fail(f"generate: the JSON answer ({reply.status_code}, {reply.content[:200]!r}) "
                      f"is not the stream's text {done['text']!r}")
            solo = lane.engine.decode_solo(prompt, budget)
            if [e["token"] for e in events[:-1]] != solo:
                _fail("generate: the stream through the gateway is not decode_solo's tokens")
            nope = client_lib.request("POST", f"{base}/generate/nope", b'{"prompt": "x"}',
                                      {"Content-Type": "application/json"}, timeout=60)
            if nope.status_code != 404:
                _fail(f"generate: /generate/nope answered {nope.status_code}, not 404")
            slo = client_lib.fetch_slo(base)
            gens = [body["decode"]["window"]["generations"]
                    for body in slo.get("replicas", {}).values()
                    if isinstance(body, dict) and isinstance(body.get("decode"), dict)]
            if gens != [2]:
                _fail(f"generate: /debug/slo's decode sections count {gens} generations, not [2]")
            out.update(tokens=done["tokens"], ttft_ms=done["ttft_ms"], tpot_ms=done["tpot_ms"],
                       request_id=stats.get("request_id"), slo_generations=gens[0],
                       stream_equals_json=True, stream_equals_solo=True, nope_status=404)
            print(client_lib.render_decode_slo(slo), flush=True)
        finally:
            gw.shutdown()
    finally:
        server.shutdown()
    return out


def _gen_load(engine, continuous: bool, requests) -> dict:
    """``requests`` submitted at once to a scheduler (continuous or static)
    on ``engine``: TTFT and TPOT p50/p99 (ms), tokens/s from the first
    submission to the last token."""
    from kubernetes_deep_learning_tpu_torch.runtime.decode import DecodeScheduler

    sched = DecodeScheduler(engine, continuous=continuous)
    sched.start()
    t0 = time.perf_counter()
    gens = [sched.submit(p, n, rid=f"load-{i}") for i, (p, n) in enumerate(requests)]
    for gen in gens:
        for _ in gen.iter_events(timeout_s=120.0):
            pass
    sched.close()
    if any(g.finish_reason not in ("stop", "length") for g in gens):
        _fail(f"generate: the {'continuous' if continuous else 'static'} load run finished "
              f"{sorted({g.finish_reason for g in gens}, key=str)}")
    _gen_pages_back(engine, "a load run")
    wall = max(g.t_last for g in gens) - t0
    tokens = sum(len(g.tokens) for g in gens)

    def pct(xs) -> dict:
        xs = np.asarray([x for x in xs if x is not None]) * 1e3
        return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99))}

    return {"arm": "continuous" if continuous else "static", "requests": len(gens),
            "tokens": tokens, "seconds": wall, "tokens_per_s": tokens / wall,
            "ttft_ms": pct(g.ttft_s() for g in gens), "tpot_ms": pct(g.tpot_s() for g in gens)}


def _gen_replay_ms(engine) -> dict:
    """Each graph's device time a replay (CUDA events over GEN_REPLAYS
    replays), on a placeholder input that writes the trash page only."""
    from kubernetes_deep_learning_tpu_torch.runtime.decode import STEP

    out = {}
    for key, g in engine._graphs.items():
        g.static_in.zero_()
        if key != STEP:
            g.static_in[key] = 1
        g.graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GEN_REPLAYS):
            g.graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[str(key)] = start.elapsed_time(end) / GEN_REPLAYS
    return out


def _generate_phase(seed: int, smi: str, device: str = "cuda") -> dict:
    """The generative lane on the card (ROADMAP A12); see the module
    docstring, phase 26.  (``device="cpu"`` rehearses it without a card,
    with the engine's graph count patched in.)"""
    from kubernetes_deep_learning_tpu_torch.runtime import decode as decode_lib

    t_phase = time.perf_counter()
    out: dict = {"model": "gen-default", "card": smi}
    engine = decode_lib.DecodeEngine("gen-default", device=device)
    t0 = time.perf_counter()
    report = engine.warmup()
    out["warmup_s"] = time.perf_counter() - t0
    programs = sorted(map(str, engine._graphs))
    if engine.graphs_captured != len(engine.prompt_buckets) + 1 or report["graphs"] != 4:
        _fail(f"generate: warmup captured {programs}, not the 3 prefill buckets and the step")
    out["graphs"] = {"captured": engine.graphs_captured, "programs": programs,
                     "slots": engine.max_slots, "page": engine.page_size,
                     "pages_a_sequence": engine.max_pages_per_seq}
    _gen_pages_back(engine, "warmup")
    out["graph_vs_eager"] = _gen_graph_check(engine)
    _gen_pages_back(engine, "the graph check")
    out["batch_vs_solo"] = {"4": _gen_batch_vs_solo(engine, GEN_REQUESTS, 0.0)}
    saved = os.environ.get(decode_lib.SLOTS_ENV)
    os.environ[decode_lib.SLOTS_ENV] = str(GEN_CHURN_SLOTS)
    try:
        churn = decode_lib.DecodeEngine("gen-default", device=device)
    finally:
        if saved is None:
            os.environ.pop(decode_lib.SLOTS_ENV)
        else:
            os.environ[decode_lib.SLOTS_ENV] = saved
    if churn.max_slots != GEN_CHURN_SLOTS:
        _fail(f"generate: {decode_lib.SLOTS_ENV}={GEN_CHURN_SLOTS} gave {churn.max_slots} slots")
    churn.warmup()
    out["batch_vs_solo"][str(GEN_CHURN_SLOTS)] = _gen_batch_vs_solo(
        churn, _gen_requests(GEN_CHURN_SLOTS, seed), GEN_CHURN_STAGGER_S)
    churn.close()
    with tempfile.TemporaryDirectory() as root:
        out["wire"] = _gen_wire_check(root, "hello from the card", 24, device)
    out["replay_ms"] = _gen_replay_ms(engine)
    load = _gen_requests(GEN_LOAD, seed + 1)
    out["load"] = [_gen_load(engine, continuous, load) for continuous in GEN_ARMS]
    engine.close()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _print_server(summary: dict, buckets: list[dict], smi: str) -> None:
    """A served model's lines: the summary, each bucket graph against the
    eager forward, the traced replay's launches, the device memory the
    warmup reserved, and p50 and img/s per bucket."""
    print("server:", json.dumps(summary), flush=True)
    for key in ("graphs", "trace_launches", "graph_memory"):
        tag = key.replace("_", "-").replace("graphs", "graph")
        print(f"{tag}:", json.dumps({**summary[key], "card": smi}), flush=True)
    for b in buckets:
        print("bucket:", json.dumps({**b, "card": smi}), flush=True)


def _card(query: str, fmt: str = "csv,noheader") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace bucket-16 forwards with torch.profiler")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    from kubernetes_deep_learning_tpu_torch.modelspec import (
        CLOTHING_MODEL,
        EFFICIENTNET_B3_IMAGENET,
        RESNET50_IMAGENET,
        VIT_B16_IMAGENET,
        ModelSpec,
    )
    from kubernetes_deep_learning_tpu_torch.models import init_variables
    from kubernetes_deep_learning_tpu_torch.models.vit import VIT_CONFIGS
    from kubernetes_deep_learning_tpu_torch.ops import _build
    from kubernetes_deep_learning_tpu_torch.ops import attention as attn
    from kubernetes_deep_learning_tpu_torch.ops import fused_mbconv, fused_sepconv
    from kubernetes_deep_learning_tpu_torch.weights import from_jax_variables

    smi = _card("name,power.limit")
    print(f"card: {smi}", flush=True)
    sm_mhz = float(_card("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = SFU_EXP_PER_CLOCK_SM * sms * sm_mhz * 1e6
    print("card:", json.dumps({"sms": sms, "max_sm_clock_mhz": sm_mhz,
                               "sfu_exp_per_s": exp_rate}), flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    entry, flash = "", {}
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill stores" in line:
            print(f"build: {entry}: {line.strip()}")
            if "flash_fwd" in entry:  # registers and spills of each flash kernel
                kernel = entry[entry.index("flash_fwd"):].split("EEEv")[0]
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores")):
                    found = re.search(pat, line)
                    if found:
                        flash.setdefault(kernel, {})[key] = int(found.group(1))
        elif "serialized" in line:
            print(f"build: {line.strip()}")
    print("build: flash kernels:", json.dumps(flash), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    # --- Xception clothing-model: K1, K2 and its server ---
    variables = init_variables(CLOTHING_MODEL, seed=args.seed)
    kernels = _kernel_phase(from_jax_variables(variables), ITERS, gen)
    _stage_phase(ITERS, gen, smi)
    summary, buckets = _server_phase(
        CLOTHING_MODEL, variables, args.seed, ITERS, args.profile, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2}, fast=True, wire="json")
    for k in kernels:
        k["launches"] = summary["launches"][k["name"]]
    _print_server(summary, buckets, smi)

    # --- the same model as int8: Q1, Q2, w8a8 and weight-only serving, the gate ---
    quant, int8_kernels = _quant_phase(CLOTHING_MODEL, args.seed, ITERS, smi, gen, args.profile)
    print("quant:", json.dumps({**quant, "card": smi}), flush=True)

    # --- the same model behind the batcher: one-image traffic, three arms ---
    print("event-wait:", json.dumps({**_event_wait_probe(sm_mhz), "card": smi}), flush=True)
    batching = _batching_phase(CLOTHING_MODEL, variables, args.seed, smi, counter=fused_sepconv,
                               per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2},
                               profile=args.profile)
    depth2_img_s = float(np.median([r["img_per_s"] for r in batching if r["arm"] == "depth2"]))

    # --- Xception's entry-kernel path: K5, K2 at blocks 3/4, the forward A/B ---
    k5, k2_entry = _entry_kernel_phase(from_jax_variables(variables), ITERS, gen)
    kernels[1]["entry_path"] = k2_entry
    entry_path = _entry_path_phase(CLOTHING_MODEL, variables, args.seed, ITERS, args.profile,
                                   k5["ms"])
    del variables
    k5["launches"] = entry_path["launches"]["fused_entry_block"]
    kernels[1]["entry_path"]["launches"] = entry_path["launches"]["fused_sepconv_chain"]
    print("entry-path:", json.dumps({**entry_path, "card": smi}), flush=True)

    # --- ViT-B/16 at 384 px: K3 and its server; the 256-px routing check ---
    k3 = _attention_phase(ITERS, gen, exp_rate)
    vit = ModelSpec(labels=VIT_B16_IMAGENET.labels, **VIT_384_KW)
    summary, buckets = _server_phase(
        vit, init_variables(vit, seed=args.seed), args.seed, ITERS, args.profile,
        counter=attn, per_forward={"flash_attention": VIT_CONFIGS[vit.family].depth}, fast=False,
        wire="msgpack")
    k3["launches"] = summary["launches"]["flash_attention"]
    kernels.append(k3)
    _print_server(summary, buckets, smi)
    print("routing:", json.dumps(_routing_phase(args.seed)), flush=True)
    k3g = _gfold_phase(ITERS, gen, exp_rate)

    # --- ViT-B/16 training at 256 px: K3P, gradients, fit, checkpoint, serve ---
    k3p = _partials_phase(ITERS, gen, exp_rate)
    grads = _grads_phase(gen, ITERS)
    print("grads:", json.dumps(grads), flush=True)
    train, k3p["launches"] = _training_phase(args.seed, args.profile, grads, smi)
    kernels.append(k3p)
    print("train:", json.dumps(train), flush=True)

    # --- EfficientNet-B3 at 300 px: K4 and its server, fused and fast=False ---
    variables = init_variables(EFFICIENTNET_B3_IMAGENET, seed=args.seed)
    k4 = _mbconv_phase(from_jax_variables(variables), args.seed, ITERS, gen, exp_rate)
    summary, buckets = _server_phase(
        EFFICIENTNET_B3_IMAGENET, variables, args.seed, ITERS, args.profile, counter=fused_mbconv,
        per_forward={"fused_mbconv_block": B3_FUSED_PER_FORWARD}, fast=True, wire="msgpack",
        unfused=True)
    del variables
    k4["launches"] = summary["launches"]["fused_mbconv_block"]
    kernels += [k4, k5, k3g, *int8_kernels]
    _print_server(summary, [*buckets, summary["unfused"]], smi)

    # --- ResNet50 at 224 px (BASELINE config 3): cuDNN convolutions, no hand kernel ---
    print("resnet:", json.dumps(_resnet_phase(args.seed, ITERS, args.profile, smi)), flush=True)

    # --- ResNet50 and EfficientNet-B3 as int8 (A8c): Q1, Q2, the three arms ---
    t0 = time.perf_counter()
    for spec in (RESNET50_IMAGENET, EFFICIENTNET_B3_IMAGENET):
        family = _quant_family_phase(spec, args.seed, QUANT_FAMILY_ITERS, smi, gen,
                                     int8_kernels)
        print("quant-family:", json.dumps({**family, "card": smi}), flush=True)
    print(f"quant-family: both families took {time.perf_counter() - t0:.1f} s", flush=True)

    # --- the admission front door on clothing-model (K1, K2): 504, overload A/B, drain ---
    admission = _admission_phase(
        CLOTHING_MODEL, init_variables(CLOTHING_MODEL, seed=args.seed), args.seed, smi,
        depth2_img_s, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})
    print("admission:", json.dumps(admission), flush=True)

    # --- the multi-model tier: ViT and clothing-model on one scheduler; hot reload ---
    print("multimodel-summary:", json.dumps(_multimodel_phase(CLOTHING_MODEL, vit, args.seed, smi)),
          flush=True)
    print("reload:", json.dumps(_reload_phase(
        CLOTHING_MODEL, args.seed, smi, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})), flush=True)

    # --- observability: span trees, SLO, MFU and busy gauges, profile, incident ---
    print("observability:", json.dumps(_observability_phase(
        CLOTHING_MODEL, args.seed, smi, depth2_img_s, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})), flush=True)

    # --- the decoder's breadth on this host: every format fixture vs PIL's digest ---
    print("ingest-formats:", json.dumps(_ingest_formats_phase(smi)), flush=True)

    # --- the gateway path: POST /predict {"url"} through the port's gateway ---
    print("gateway:", json.dumps(_gateway_phase(
        CLOTHING_MODEL, args.seed, smi, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})), flush=True)

    # --- device-resize staging: the staged bucket graphs, against host resize ---
    print("device-resize:", json.dumps(_device_resize_phase(
        CLOTHING_MODEL, args.seed, smi, counter=fused_sepconv,
        per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})), flush=True)

    # --- the BatchNorm families' train mode: fine-tune, checkpoint, export, serve ---
    t0 = time.perf_counter()
    train_bn = {CLOTHING_MODEL.name: _train_bn_phase(
        args.seed, smi, per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})}
    for spec, per_forward, tol in (
            (RESNET50_IMAGENET, {}, RESNET_TOL),
            (EFFICIENTNET_B3_IMAGENET, {"fused_mbconv_block": B3_FUSED_PER_FORWARD}, MODEL_TOL)):
        train_bn[spec.name] = _train_bn_family(spec, args.seed, smi, TRAIN_STEPS // 2,
                                               per_forward=per_forward, tol=tol)
    train_bn["seconds"] = time.perf_counter() - t0
    print("train-bn:", json.dumps(train_bn), flush=True)

    # --- the lifecycle: Keras .h5 -> export, inspect, warm -> server, gateway -> client ---
    t0 = time.perf_counter()
    export = _export_phase(CLOTHING_MODEL, args.seed, smi,
                           per_forward={"fused_sepconv_block": 8, "fused_sepconv_chain": 2})
    export["phase_s"] = time.perf_counter() - t0
    print("export:", json.dumps(export), flush=True)

    # --- the generative lane: paged-KV decode on CUDA graphs, :generate on the wire ---
    print("generate:", json.dumps(_generate_phase(args.seed, smi)), flush=True)

    print("smoke:", json.dumps({"seconds": time.perf_counter() - t_script, "card": smi}))
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
