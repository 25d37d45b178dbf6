"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero with its traceback:

1. identity: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions; then every CUDA kernel is built from this checkout's
   sources (one nvcc per source, in parallel) and the build time printed.
2. kernels: each kernel at the main path's shapes (Multiband-MelGAN at full
   width, 248 mel frames + 2x2 inference padding, batch 8) against its plain
   PyTorch version on the same inputs, TF32 off; the error must stay within
   1e-4 of the largest reference magnitude. One JSON line per kernel with
   its time, the plain version's, a library call's where one exists, and
   the least time the card could take (bytes at 3.35 TB/s or fp32 FLOPs at
   67 TFLOP/s, whichever is larger).
3. serving: random full-width Glow-TTS and Multiband-MelGAN (seeded; the
   duration head pinned to 6 frames per symbol) saved as port checkpoints,
   served by the port's HTTP server in a thread; requests of different
   lengths must return finite, non-silent WAVs of the expected length, the
   kernel launch counts (zeroed just before) must all rise, and the served
   audio must match the same Synthesizer run on the CPU (plain versions).
4. batched: Glow-TTS at batch 128 (128 symbols, 248 frames) then the
   generator; audio-seconds per second beside the card's name and limit.
5. mas: the monotonic-alignment-search kernel at the training path's shapes
   (B=32, T_x=192, T_y=864, ragged lengths from the seed), on random
   log-likelihoods, on integers full of exact ties and on a mask with zeros
   inside its lengths; its path must equal the plain version's exactly. One
   JSON line each with its time, the plain version's, the byte bound, the
   latency floor of the columns' dependent chain, and torch.profiler's
   device time by kernel function over one call (all the call puts on the
   card).
6. training: a synthetic LJSpeech-format corpus (96 utterances of 25-185
   characters, tone plus noise at ~15 characters per second, 1.5-10 s) and
   configs/glow_tts_ljspeech.json at full width, batch 32, 2 epochs, trained
   through bin/train_glow_tts on the card. Every loss must be finite, the
   parameters must change, the MAS launch count (zeroed just before) must be
   steps + 1 (the + 1 is the DDI pass), and the last checkpoint must serve
   finite, non-silent audio through the Synthesizer. Prints ms per step and
   MAS's device ms per step, and the split of one step (forward, backward,
   optimizer).
7. gan kernels: the STFT-magnitude kernel at the 6 resolutions of the GAN
   losses on full-width shapes (full band on 64 x 16,384 samples, subbands
   on 256 x 4,096; full band again on ParallelWaveGAN's 6 x 25,600, whose
   few row blocks end in ragged tiles), and the grouped-conv weight- and input-gradient kernels
   at the discriminator's three kernel layers of scale 0 at batch 64, each
   against its plain version (dW within 1e-4 of its largest magnitude, dx
   within 1e-5 absolute, each bitwise equal across two calls), with times, a
   library call's time and the bound (B5's: frames, window and banks in and
   magnitudes out once, or a real FFT's 2.5 K log2 K operations a frame);
   then the STFT Function's gradient against autograd through the plain
   version on the card.
8. gan training: configs/multiband_melgan.json at full width (batch 64,
   16,384 samples, mixed precision as configured) on the synthetic corpus
   for 4 epochs of one step, the discriminator from step 1 on, through
   bin/train_vocoder. The launch counts (zeroed just before) must equal
   what the step counts give: per step 12 STFT magnitudes (6 resolutions x
   y_hat and y); per step with the discriminator 27 input gradients (9
   kernel layers in the generator update, 2 x 9 in the discriminator
   update) and 18 weight gradients (discriminator update only). Every loss
   must be finite, both networks' parameters must move, and the last
   generator checkpoint must serve finite, non-silent audio through the
   Synthesizer. Prints ms per step, loader ms, and the split of a step
   (generator and discriminator updates, each forward / backward /
   optimizer, device and host-enqueue time, kernels' device time, and the
   device time of the STFT magnitude's backward: plain matmuls).

9. taco2 kernels: bench.py's Tacotron2 at full width (r = 2, batch 64,
   128 symbols, seeded): the encoder BiLSTM kernel (B7) on the conv
   stack's output and the decode kernels (B8) on B7's output, each against
   its plain version (1e-4 of the largest magnitude; B8 over 16 steps, then
   124 steps with the largest deviation of each output reported and every
   output finite), with times, cuDNN's LSTM as B7's yardstick (B8 has
   none) and the bound (B8: fp32 FLOPs of the conv form); then B8 at
   serving's shape (one item, a 64-symbol bucket, 80 steps) timed, and
   torch.profiler's device time by kernel for B7 and 16 decode steps at
   both batches.
10. taco2 serving: a seeded full-width configs/tacotron2_ljspeech.json
   model (r 7, r_init 7, the DDC coarse decoder present; stopnet silenced,
   80 decoder steps served) with the Multiband-MelGAN of phase 3, served
   over HTTP: 3 requests must return finite, non-silent WAVs of 80 x 7
   frames; the B7, B8, B1 and B2 launch counts (zeroed just before) must be
   what the requests give; the audio must match the same Synthesizer on the
   CPU within 1e-3 through 16-bit WAV (the first decoder step where the two
   mels differ by more than 1e-4 is printed).
11. taco2 batched: bench.py's taco2 pipeline (batch 64, 128 symbols, 124
   steps at r = 2, then the generator on 248 frames): audio-seconds per
   second and the split into encoder, decode, postnet and vocoder.
12. glow encoder kernel: the whole eval-mode Glow encoder kernel (B3) at
   full width (configs/glow_tts_ljspeech.json through the registry, every
   parameter refilled from the seed) against its plain version at bench.py's
   batch (128 x 128 symbols), the serving bucket (1 x 96, length 80) and a
   ragged batch (16 x 192, lengths 40-192): within 1e-4 of the largest plain
   magnitude, padded rows exactly 0, the launches of one call as derived;
   times, the bound and torch.profiler's device time by kernel function.
   Then GlowTTS.encode at the longest text B3's attention block holds (as
   glow_encoder.cu exports it) and one symbol longer: B3 runs at the limit,
   the module above it, both matching the module.
13. cli: `tts_tpu_torch.bin.synthesize` in-process on phase 3's full-width
   checkpoints, with the Multiband-MelGAN vocoder and without it
   (Griffin-Lim, one short sentence): WAVs of the expected length, finite
   and not silent; B3 launches one call per sentence in both runs, B1/B2
   only in the vocoder run; the vocoder run's audio equals the same call on
   the CPU within 1e-3.

14. taco2 training: configs/tacotron2_ljspeech.json as shipped (batch 64
   at r 7, then 32 at r 4 and r 2; DDC; bfloat16 mixed precision;
   phonemes) on the synthetic corpus through bin/train_tts, its gradual
   schedule's step boundaries moved to 0, 3 and 6 (depth, not width), 7
   epochs with eval epochs and the test sentences in the last. First the
   first batch in bfloat16 against float32 (same weights and dropout
   masks): losses within 5e-3 relative, the decoder and postnet outputs
   apart by 2^-12 to 5e-2 of their norm; then every loss finite, every
   trained tensor moved (the coarse decoder's stopnet aside: no loss reads
   its logits), the tensors held fixed unmoved, every BatchNorm's running
   statistics moved and still float32; step-time medians per r, loader
   ms, peak memory. The
   test sentences run B7 once per sentence (1 + text bucket launches) and
   B8 for 80 steps (8 a step); the last checkpoint serves through the
   Synthesizer with the Multiband-MelGAN vocoder (B7, B8, B1, B2 counted),
   and its fast path matches the plain decode on the trained weights for
   at least 16 steps (1e-4). Then the split of a step at r 7 and r 2:
   forward with the loss, backward, optimizer (device and host-enqueue
   time), and torch.profiler's device time by kernel.
15. prewarm: phase 3's checkpoints served by the HTTP server in a process
   of its own, without --prewarm, with it over the smallest text bucket
   only (below the request's) and with it as shipped: seconds to
   listening, the prewarm's seconds, the first and second requests'
   latency.

16. pwgan training: configs/parallel_wavegan.json as shipped (30 blocks in
   3 stacks, upsample 4-4-4-4, the 10-layer discriminator, STFT and MSE-GAN
   losses, float32, batch 6 x 25,600 samples) on a 46-utterance synthetic
   corpus (36 trained: 6 steps), the discriminator from step 2 (depth, not
   width); then 2 steps against the random window discriminators (tts_tpu's
   windows, 512-8,192) on 22 utterances, the discriminator from step 0.
   Through bin/train_vocoder; B5 must launch 6 times a step (3 resolutions
   x y_hat and y; no subbands), B6 never; every loss finite, both networks'
   parameters moved. Prints step times, loader ms, peak memory, and one
   step with the discriminator profiled: device busy ms and idle share.
17. istft training: configs/istft_melgan.json as shipped (base 512,
   upsample 8-8, head n_fft 16 / hop 4, bf16 mixed precision, batch 64 x
   16,384) against the multiscale MelGAN discriminator on the 96-utterance
   corpus, 4 epochs of one step, the discriminator from step 2. First the
   first batch's generator losses in bfloat16 against float32 on the seeded
   weights (spectral convergence and adversarial terms within 2e-2
   relative, every term finite; the waveforms apart by 2^-12 to 0.2 of
   their norm). B5 6 launches a step, B6 27 input and 18 weight gradients a
   step with the discriminator (phase 8's counts); the same prints as 16.
18. vocoder serving: phase 3's Glow-TTS in front of the generators of 16
   and 17 (their last checkpoints, weight norm folded, each through its
   module's inference; PWGAN's noise from a CPU generator seeded 0 a
   sentence): 3 requests over HTTP (first and warm latency), B3 launched
   once a sentence and no B1/B2; the vocoder on the card against the CPU on
   the same mel within 1e-3; the synthesis CLI once per vocoder; then each
   generator alone at phase 2's geometry (batch 8, 248 + 4 frames): ms,
   audio-seconds per second, and its fp32 bound from the convolutions'
   FLOPs in that call.

19. speaker encoder: configs/speaker_encoder.json as shipped (3 x LSTM
   768 -> 256, GE2E softmax, 64 speakers x 10 utterances of 1.6 s at
   16 kHz, the storage replay as configured) on a synthetic voxceleb1-style
   tree of 64 speakers x 11 utterances (each speaker its own pitch and
   harmonic weights; the loader holds one utterance of the tree out), 4
   steps through bin/train_encoder: every loss finite,
   no hand-written kernel launched (the encoder's LSTMs are cuDNN's, as
   tts_tpu's are XLA's); step and loader ms, one step profiled (device
   busy ms, idle share, launches), peak memory, forward FLOPs; the GE2E
   loss on the card against the CPU on the same weights and the first 16
   speakers of the last batch (1e-4 relative). Then the sliding-window
   d-vectors of every utterance of a synthetic VCTK-style corpus (8
   speakers x 12, 22,050 Hz, resampled to 16 kHz by load_wav) into
   speakers.json.
20. multi-speaker training on that corpus, each config at its shipped
   widths through its training CLI: configs/glow_tts_ljspeech.json with
   use_speaker_embedding (8 speaker ids; 2 epochs of 2 steps; B4 once a
   step plus the DDI pass, B3 never), configs/tacotron2_ljspeech.json
   reading phase 19's speakers.json (decoder input 512 + 256), and the
   same with use_gst (512 + 256 + 512; the registry's GST defaults), each
   3 epochs of one step at r 7 (batch 64, bf16 mixed precision, DDC); B8
   never, B7 only in the eval epochs. Every loss finite; step, loader ms,
   peak memory, and the longest batch's step profiled (idle share).
21. multi-speaker serving: the trained Glow with phase 3's
   Multiband-MelGAN over HTTP with ?speaker_id= 0 and 1 (the two differ,
   repeats are equal; B1/B2 launched, B3 not; first and warm latency), the
   CLI with --speaker_id 1 (equal to the server's audio), and the mel on
   the card against the CPU (noise 0) within 1e-4 of its largest
   magnitude; the two Tacotron2 checkpoints through synthesis() with a
   d-vector (and a style wav): B7 1 + text bucket launches a sentence, B8
   none, two speakers' mels differ, and the decode on the card against the
   CPU on the same weights agrees within 1e-4 for at least 16 steps (the
   first step apart printed).

22. tacotron v1: configs/tacotron2_ljspeech.json built in code with model
   "tacotron", attention_norm "sigmoid" and memory_size 5 (the queue on,
   no longer than r; the overrides printed), its audio (1024-point FFT:
   513 linear bins), gradual schedule and bf16 mixed precision, 3 epochs
   of one step at r 7 (batch 64) on the synthetic corpus through
   bin/train_tts with eval epochs and the test sentences, one of them made
   to fail: training goes on and writes its checkpoint, the other two give
   audio. Every loss finite, the post-net's target the linear spectrogram,
   every BatchNorm's running statistics moved; step and loader ms, peak
   memory and the longest batch's step profiled (idle share). The
   checkpoint with Griffin-Lim over HTTP (3 requests) and the CLI at 80
   steps, B7 and B8 never launched; the decode on the card against the
   CPU within 1e-4 for at least 16 steps; a mel vocoder refused (C26).
23. graves: a Tacotron2 at tacotron2_ljspeech.json's widths with Graves
   attention (5 components): one training step (bf16, DDC) with finite
   losses and Graves's weights moved, then one sentence three times
   through synthesis() at 80 steps: B7 1 + text bucket launches a call,
   B8 none;
   card against CPU as in 22.
24. streaming: phase 10's Tacotron2 and phase 3's Multiband-MelGAN through
   Synthesizer.tts_stream on a sentence of four 48-character chunks, 128
   steps a chunk: one B7 call (1 + bucket launches) per chunk, B2's
   proj_in and tail once a chunk, B8 none; the time to the first chunk
   and to the whole stream beside tts() of the same text; the first
   chunk's mel on the card against the CPU within 1e-4 of its largest
   magnitude; a Tacotron v1 model refused (C25).
25. glow encoders: configs/glow_tts_ljspeech.json with encoder_type
   "gatedconv", then "time-depth-separable", 2 epochs of 2 steps at batch
   32 through bin/train_glow_tts: B4 once a step plus the DDI pass, B3
   never, every loss finite, the separable encoder's BatchNorm statistics
   moved and in the checkpoint; step and loader ms, peak memory, a step
   profiled; served over HTTP with phase 3's vocoder (B3 none, B1/B2
   launched), and the mel on the card against the CPU (noise 0) within
   1e-4 of its largest magnitude.

26. wavernn: configs/multiband_melgan.json's audio with generator_model
   "wavernn" at fatchord's width (rnn and fc 512, compute and res-out 128,
   10 res blocks, pad 2, upsample 4-8-8 = hop 256, 10 bits), seeded,
   behind phase 3's Glow-TTS: 3 requests of different lengths over HTTP
   and one through the CLI, each WAV finite, non-silent and n * hop
   samples long, B3 38 launches a sentence, B1/B2 none; a WaveRNN whose
   upsampling is not the hop refused at load (tts_tpu's check); on the
   sampled sequence of the shortest request, the teacher-forced logits on
   the card against the CPU (1e-4 of the largest) and the CPU's logits
   redrawn at the same uniforms giving the card's ids, but where a
   uniform lies within 1e-5 of a class boundary (counted); one request
   through a mold-mode WaveRNN (10 mixtures). Prints each request's ms
   split into Glow and WaveRNN, us a sample, the RTF, the sample loop
   profiled (kernels a sample, device busy ms, idle share) and the bytes
   a sample reads with the bound they give.
27. eval_model: bin/eval_model on the card on seeded full-width
   glow_tts_ljspeech.json and tacotron2_ljspeech.json checkpoints over a
   16-utterance synthetic corpus (all held out, 2 batches of 8): B4 one
   launch a batch, B7 1 + the text bucket a batch, the metrics within
   1e-4 relative of the same run on the CPU; seconds an item.
28. tools: bin/compute_statistics on that corpus against the same
   statistics computed two-pass in float64 (means within 1e-5, standard
   deviations within 1e-3 relative: the script's one float32 pass is
   tts_tpu's); bin/convert_torch_checkpoint on legacy .pth.tar files of
   phase 3's Multiband-MelGAN and phase 26's WaveRNN, each served audio
   within 1e-5 of the original checkpoint's.
29. export: phase 3's Multiband-MelGAN (2 x 248 frames) and Glow-TTS (96
   symbols, noise 0, 1,024 frames) exported on the CPU through
   bin/export_model, loaded and run on the card against the served kernel
   path (B1/B2, B3) within 1e-4 of the largest magnitude; the export
   seconds.

30. multi-device: (1) bin/distribute runs bin/train_tts on
   configs/tacotron2_ljspeech.json as shipped (use_data_parallel, r 7,
   batch 64, bf16) over NCCL with one rank, 2 epochs of one step on the
   synthetic corpus: every loss finite, rank 0's one checkpoint the only
   file written, ms a step beside phase 14's. (2) gloo, 2 ranks on this
   card (``chip_smoke.py --dp-rank R ...``, one process each), full width,
   fp32, items of one length: the Glow-TTS (batch 32, 16 a rank, its DDI
   pass on the global batch), Tacotron2 (64, 32 a rank, eval mode) and
   Multiband-MelGAN GAN (64 x 16,384, 32 a rank) DP steps each against the
   single-process step on the same global batch (the total loss rtol 1e-5,
   every tensor atol 1e-6 rtol 1e-4: tts_tpu's tolerances) with the same
   launches per rank as the single process (B4 2: the DDI pass and the
   step; B5 12, B6 27 + 18), then 3 train-mode steps after which the two
   ranks' states are bitwise equal. (3) make_dp_serving of phase 4's
   pipeline (batch 8 x 128 symbols, 248 frames, noise 0) at gloo 2 and
   NCCL 1 (in this process): the audio within 1e-4 of the single call's
   largest magnitude, each rank's B1/B2/B3 launches equal to the single
   call's. (4) Multiband-MelGAN channel-sharded over a (data 1, model 2)
   mesh against the unsharded generator (1e-4 of the largest), the sharded
   layers printed.

Each of phases 22-30 prints its seconds (``phase_s``).

Phases 3 and 4 run Glow's encoder through B3 too: phase 3 asserts its
launches (one call per sentence), phase 4 prints its share of glow_ms.

The second-last line is the kernels JSON; the last is the ok line.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

SEED = 0
BATCH = 8                  # kernel phase batch
MEL_FRAMES = 248           # bench.py's geometry
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12   # H100 SXM, CUDA cores (no tensor cores)
TOL = 1e-4                 # relative to max |reference|


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_identity() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    from tts_tpu_torch.ops.cuda.build import _nvcc
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernel_profile(fn) -> dict:
    """Device time (us) and launches by kernel name over one call of fn,
    from torch.profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            name = re.search(r"(\w+(<[\w, ]+>)?)\(", ev.key)
            out[name.group(1) if name else ev.key[:60]] = {
                "us": us, "launches": ev.count}
    return out



def busy_summary(prof: dict, step_ms: float, top: int) -> dict:
    """From ``kernel_profile`` of one step and the step's median time: the
    kernels' device time, their launches, the share of the step in which
    no kernel runs, and the ``top`` busiest kernels."""
    busy_ms = sum(v["us"] for v in prof.values()) / 1e3
    busiest = sorted(prof.items(), key=lambda kv: -kv[1]["us"])[:top]
    return {"step_ms_median": step_ms, "kernel_busy_ms_per_step": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / step_ms),
            "kernels_launched": sum(v["launches"] for v in prof.values()),
            "top_kernels_us": dict(busiest)}


def step_profile(step, reps: int = 3, top: int = 6) -> dict:
    """``step()`` timed between events (median of ``reps``) and profiled
    once more (``busy_summary``)."""
    times = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    return {"step_device_ms": times,
            **busy_summary(kernel_profile(step), float(np.median(times)),
                           top)}

def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not np.isfinite(err) or err > TOL * scale:
        raise AssertionError(f"{name}: max |err| {err} > {TOL} * {scale}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------

def kernel_phase(dev):
    from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
    from tts_tpu_torch.models.vocoder.multiband_melgan import \
        MultibandMelganGenerator
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R

    torch.manual_seed(SEED)
    gen = MultibandMelganGenerator(base_channels=384,
                                   upsample_factors=(2, 8, 2, 2),
                                   num_res_blocks=4)
    sd = fold_weight_norm(gen.state_dict())
    w = M.pack_generator_params(gen, sd, dev)
    pad = gen.inference_padding
    mel = torch.randn(BATCH, MEL_FRAMES, 80, device=dev)

    # the main path's intermediates, produced by the kernels themselves
    x0 = M.proj_in_cuda(mel, w.proj_in_w, w.proj_in_b, pad)
    stage_in, stack_in = [], []
    x = x0
    for up, stack in zip(w.upsamples, w.stacks):
        stage_in.append(x)
        x = M.upsample_cuda(x, up)
        stack_in.append(x)
        x = R.residual_stack_nct(x, *stack)
    tail_in = x

    results = {}

    # proj_in (edge pad + reflect conv k=7)
    got = M.proj_in_cuda(mel, w.proj_in_w, w.proj_in_b, pad)
    want = M.proj_in_plain(mel, w.proj_in_w, w.proj_in_b, pad)
    Tp = MEL_FRAMES + 2 * pad
    wt = M._proj_in_conv_weight(w.proj_in_w).contiguous()
    C0, Cm, K = wt.shape
    padded = torch.nn.functional.pad(
        torch.nn.functional.pad(mel.transpose(1, 2), (pad, pad),
                                mode="replicate"), (K // 2, K // 2),
        mode="reflect").contiguous()
    results[M.PROJ_IN] = dict(
        err=check_close(M.PROJ_IN, got, want),
        ms=cuda_time_ms(lambda: M.proj_in_cuda(mel, w.proj_in_w,
                                               w.proj_in_b, pad), 20),
        plain_ms=cuda_time_ms(lambda: M.proj_in_plain(mel, w.proj_in_w,
                                                      w.proj_in_b, pad), 20),
        library_ms=cuda_time_ms(lambda: torch.nn.functional.conv1d(
            padded, wt, w.proj_in_b), 20),
        bound=bound_ms(nbytes(mel, got, w.proj_in_w, w.proj_in_b),
                       2.0 * BATCH * Tp * C0 * Cm * K))

    # upsamples (leaky + polyphase transposed conv), summed over the stages
    res = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nb=0, fl=0.0)
    for xin, up in zip(stage_in, w.upsamples):
        got = M.upsample_cuda(xin, up)
        res["err"] = max(res["err"], check_close(
            M.UPSAMPLE, got, M.upsample_plain(xin, up)))
        res["ms"] += cuda_time_ms(lambda: M.upsample_cuda(xin, up), 20)
        res["plain_ms"] += cuda_time_ms(lambda: M.upsample_plain(xin, up), 5)
        f = up.factor
        B, Ci, T = xin.shape
        Co = 4 * up.w.shape[1]
        # yardstick: cuDNN's transposed conv of the same size (on leaky(x))
        lx = torch.nn.functional.leaky_relu(xin, 0.2)
        conv_w = torch.randn(Ci, Co, 2 * f, device=dev)
        res["library_ms"] += cuda_time_ms(
            lambda: torch.nn.functional.conv_transpose1d(
                lx, conv_w, up.bias, stride=f, padding=up.padding), 20)
        res["nb"] += nbytes(xin, got, up.w, up.bias)
        res["fl"] += 2.0 * B * T * f * Co * 2 * Ci
    res["bound"] = bound_ms(res.pop("nb"), res.pop("fl"))
    results[M.UPSAMPLE] = res

    # residual stacks: every block of every stage
    res = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=None, nb=0, fl=0.0)
    for stage, (xin, (w1, b1, w2, bout)) in enumerate(zip(stack_in,
                                                          w.stacks)):
        got = R.residual_stack_nct(xin, w1, b1, w2, bout)
        want = xin
        for j in range(w1.shape[0]):
            want = R.residual_block_plain(want, w1[j], b1[j], w2[j], bout[j],
                                          3 ** j)
        res["err"] = max(res["err"], check_close(R.KERNEL, got, want))
        ms = cuda_time_ms(
            lambda: R.residual_stack_nct(xin, w1, b1, w2, bout), 10)

        def plain(x=xin):
            for j in range(w1.shape[0]):
                x = R.residual_block_plain(x, w1[j], b1[j], w2[j], bout[j],
                                           3 ** j)
            return x
        plain_ms = cuda_time_ms(plain, 5)
        B, C, T = xin.shape
        n = w1.shape[0]
        # each block reads its input and writes its output once
        nb = n * (2 * nbytes(xin)) + nbytes(w1, b1, w2, bout)
        fl = n * 10.0 * B * T * C * C
        log({"stack_stage": stage, "channels": C, "samples": T, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms(nb, fl)[0]})
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        res["nb"] += nb
        res["fl"] += fl
    res["bound"] = bound_ms(res.pop("nb"), res.pop("fl"))
    results[R.KERNEL] = res

    # tail (leaky + proj_out k=7 + tanh + PQMF synthesis)
    got = M.tail_cuda(tail_in, w.proj_out_w, w.proj_out_b, w.syn, w.syn_q)
    want = M.tail_plain(tail_in, w.proj_out_w, w.proj_out_b, w.syn, w.syn_q)
    B, C, T = tail_in.shape
    _, K, N = w.proj_out_w.shape
    J = w.syn.shape[0]
    results[M.TAIL] = dict(
        err=check_close(M.TAIL, got, want),
        ms=cuda_time_ms(lambda: M.tail_cuda(tail_in, w.proj_out_w,
                                            w.proj_out_b, w.syn, w.syn_q), 20),
        plain_ms=cuda_time_ms(lambda: M.tail_plain(
            tail_in, w.proj_out_w, w.proj_out_b, w.syn, w.syn_q), 10),
        library_ms=None,
        bound=bound_ms(nbytes(tail_in, got, w.proj_out_w, w.syn),
                       2.0 * B * T * N * (C * K + J * N)))

    for name, r in results.items():
        log({"kernel": name, "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
             "library_ms": r["library_ms"], "bound_ms": r["bound"][0],
             "bound_by": r["bound"][1], "max_abs_err": r["err"],
             "shapes": f"batch {BATCH}, {MEL_FRAMES}+{2 * pad} mel frames"})

    # the whole generator: kernel chain against the plain chain
    got = M.megakernel_inference(gen, w, mel)
    want = _plain_generator(M, R, w, mel, pad)
    gen_err = check_close("megakernel_inference", got, want)
    gen_ms = cuda_time_ms(lambda: M.megakernel_inference(gen, w, mel), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.megakernel_inference(gen, w, mel)
    enqueue_ms = (time.perf_counter() - t0) * 1e3   # host time of 22 launches
    torch.cuda.synchronize()
    log({"generator": "megakernel_inference", "ms": gen_ms,
         "host_enqueue_ms": enqueue_ms,
         "plain_ms": cuda_time_ms(lambda: _plain_generator(M, R, w, mel, pad),
                                  5),
         "bound_ms": sum(r["bound"][0] for r in results.values()),
         "max_abs_err": gen_err,
         "launches_per_call": 1 + len(w.upsamples)
         + sum(s[0].shape[0] for s in w.stacks) + 1,
         "audio_s_per_s": BATCH * got.shape[1] / 22050 / (gen_ms / 1e3),
         "shapes": f"batch {BATCH}, {MEL_FRAMES}+{2 * pad} mel frames"})
    return results


def _plain_generator(M, R, w, mel, pad):
    x = M.proj_in_plain(mel, w.proj_in_w, w.proj_in_b, pad)
    for up, (w1, b1, w2, bout) in zip(w.upsamples, w.stacks):
        x = M.upsample_plain(x, up)
        for j in range(w1.shape[0]):
            x = R.residual_block_plain(x, w1[j], b1[j], w2[j], bout[j], 3 ** j)
    return M.tail_plain(x, w.proj_out_w, w.proj_out_b, w.syn, w.syn_q)


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------

def build_models(root: str):
    """Seeded full-width Glow-TTS and Multiband-MelGAN from the repo's
    configs, saved as port checkpoints. Returns the checkpoint paths."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.text import num_symbols

    here = os.path.dirname(os.path.abspath(__file__))
    tts_cfg = os.path.join(here, "configs", "glow_tts_ljspeech.json")
    voc_cfg = os.path.join(here, "configs", "multiband_melgan.json")
    torch.manual_seed(SEED)
    c = load_config(tts_cfg)
    glow = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    # random durations are degenerate (expm1 of ~0); pin 6 frames/symbol
    proj = glow.encoder.duration_predictor.proj
    with torch.no_grad():
        proj.weight.zero_()
        proj.bias.fill_(float(np.log(6.5)))
    voc = setup_generator(load_config(voc_cfg))
    paths = {"tts_config": tts_cfg, "vocoder_config": voc_cfg,
             "tts": os.path.join(root, "glow.pt"),
             "voc": os.path.join(root, "mbmelgan.pt")}
    torch.save({"model": glow.state_dict()}, paths["tts"])
    torch.save({"model": voc.state_dict()}, paths["voc"])
    return paths


def encoder_launches(model, texts) -> int:
    """B3 launches that serving `texts` makes: one fused encoder call per
    sentence."""
    from tts_tpu_torch.infer.synthesizer import split_into_sentences
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    calls = sum(len(split_into_sentences(t) or [t]) for t in texts)
    return calls * GEK.launches_per_call(model.encoder.packed_weights().dims)


def serving_phase(dev, root: str):
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import text_to_seqvec
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK

    paths = build_models(root)
    synth = Synthesizer(paths["tts"], paths["tts_config"], paths["voc"],
                        paths["vocoder_config"], device=dev)
    assert synth._packed is not None, "vocoder must take the kernel chain"
    cfg = load_config(paths["tts_config"])
    hop = synth.vocoder_ap.hop_length
    texts = ["Hello world!",
             "The birch canoe slid on the smooth planks.",
             "Four hours of steady work faced us, and the source of the huge "
             "river was clear."]
    build.reset_launches()
    served = []
    for text, (wav, ms) in zip(texts, served_wavs(synth, texts)):
        frames = 6 * len(text_to_seqvec(text, cfg))
        frames = -(-frames // 2) * 2
        expect = (frames * hop if frames % 32 else (frames + 4) * hop)
        expect += 10000                         # the inter-sentence gap
        assert len(wav) == expect, (len(wav), expect)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        served.append(wav)
        log({"request": text[:40], "status": 200, "samples": len(wav),
             "mel_frames": frames, "latency_ms": ms})
    launches = dict(build.LAUNCHES)
    log({"main_path_launches": launches, "requests": len(texts)})
    for name in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
        assert launches.get(name, 0) > 0, f"{name} was not launched"
    # B3: one fused encoder call per sentence, none of the plain version
    want = encoder_launches(synth.model, texts)
    assert launches.get(GEK.KERNEL, 0) == want, (launches.get(GEK.KERNEL),
                                                 want)

    # the same request on the CPU (plain versions) as the reference, through
    # the same 16-bit WAV encoding (1 LSB = 3.1e-5)
    from tts_tpu_torch.audio.processor import wav_to_bytes
    cpu = Synthesizer(paths["tts"], paths["tts_config"], paths["voc"],
                      paths["vocoder_config"], device="cpu")
    ref, _ = read_wav(wav_to_bytes(cpu.tts(texts[0]), synth.ap.sample_rate))
    assert len(ref) == len(served[0]), (len(ref), len(served[0]))
    err = float(np.abs(ref - served[0]).max())
    assert err < 1e-3, err
    log({"served_vs_cpu_max_abs_err": err})

    # where a warm request's time goes (B=1, without HTTP); both parts end
    # in a copy to the host, so the host clock sees the card's work
    from tts_tpu_torch.infer.synthesis import synthesis
    for text in texts:
        t0 = time.perf_counter()
        mel = synthesis(synth.model, text, cfg, dev,
                        generator=torch.Generator(dev).manual_seed(0))
        t1 = time.perf_counter()
        synth._vocode(mel["postnet_outputs"])
        t2 = time.perf_counter()
        log({"request_breakdown": text[:40],
             "text_and_glow_ms": (t1 - t0) * 1e3,
             "vocoder_ms": (t2 - t1) * 1e3})
    return launches


# ---------------------------------------------------------------------------
# phase 4: batched throughput
# ---------------------------------------------------------------------------

def batched_phase(dev, card: str):
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK

    here = os.path.dirname(os.path.abspath(__file__))
    torch.manual_seed(SEED)
    glow = setup_model(128, 1, load_config(
        os.path.join(here, "configs", "glow_tts_ljspeech.json")))
    glow = glow.to(dev).eval()
    glow.store_inverse()
    voc_cfg = load_config(os.path.join(here, "configs",
                                       "multiband_melgan.json"))
    voc = setup_generator(voc_cfg)
    sd = fold_weight_norm(voc.state_dict())
    packed = M.pack_generator_params(voc, sd, dev)
    batch, t_text = 128, 128
    g = torch.Generator(dev).manual_seed(1)
    text = torch.randint(1, 128, (batch, t_text), device=dev, generator=g)
    lens = torch.full((batch,), t_text, dtype=torch.int32, device=dev)

    def run():
        out = glow.inference(text, lens, noise_scale=0.33,
                             y_max_length=MEL_FRAMES, generator=g)
        mel = out["model_outputs"].float().contiguous()
        return M.megakernel_generator_apply(voc, packed, mel)

    wav = run()
    torch.cuda.synchronize()
    assert wav.shape == (batch, MEL_FRAMES * 256, 1)
    assert torch.isfinite(wav).all()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    times, split = [], []
    # the encoder's share of glow_ms: events around the encoder call that
    # inference makes (B3)
    enc_events = []
    encode = glow.encode

    def timed_encode(*args):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        out = encode(*args)
        pair[1].record()
        enc_events.append(pair)
        return out
    glow.encode = timed_encode
    build.reset_launches()
    for _ in range(3):
        t0 = time.perf_counter()
        ev[0].record()
        out = glow.inference(text, lens, noise_scale=0.33,
                             y_max_length=MEL_FRAMES, generator=g)
        ev[1].record()
        M.megakernel_generator_apply(
            voc, packed, out["model_outputs"].float().contiguous())
        ev[2].record()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    del glow.encode
    assert build.LAUNCHES[GEK.KERNEL] == 3 * GEK.launches_per_call(
        glow.encoder.packed_weights().dims), dict(build.LAUNCHES)
    times.sort()
    dt = times[1]
    audio_s = batch * MEL_FRAMES * 256 / 22050
    log({"batched": "glow+megakernel", "batch": batch, "t_text": t_text,
         "mel_frames": MEL_FRAMES, "s_per_batch": dt,
         "audio_s_per_s": audio_s / dt, "spread_pct":
         100 * (times[-1] - times[0]) / dt,
         "glow_ms": [s[0] for s in split],
         "encoder_ms_of_glow": [a.elapsed_time(b) for a, b in enc_events],
         "vocoder_ms": [s[1] for s in split],
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "card": card})


# ---------------------------------------------------------------------------
# phase 5: monotonic alignment search
# ---------------------------------------------------------------------------

MAS_SHAPE = (32, 192, 864)     # the training phase's largest batch
# MAS's latency floor (an estimate): each item's DP is a chain of t_y
# dependent columns (a shuffle, a max and an add: ~40 cycles) and its
# backtrack a chain of t_y dependent steps (~40 cycles each at most), on
# one SM, at the H100 SXM's 1.98 GHz boost clock
MAS_CYCLES_PER_COLUMN = 40 + 40
SM_CLOCK_HZ = 1.98e9


def mas_inputs(dev, case: str):
    """``case``: "random" log-likelihoods, "ties" (small integers: many
    exact ties) or "zeroed_cell" (random, and a mask with zeros inside its
    lengths, off the first row and column that give them)."""
    B, T_x, T_y = MAS_SHAPE
    g = torch.Generator().manual_seed(SEED)
    t_xs = torch.randint(T_x // 2, T_x + 1, (B,), generator=g)
    t_ys = torch.maximum(4 * t_xs, torch.randint(T_y // 2, T_y + 1, (B,),
                                                 generator=g)).clamp(max=T_y)
    t_xs[0], t_ys[0] = T_x, T_y
    if case == "ties":
        value = torch.randint(-3, 4, (B, T_x, T_y), generator=g).float()
    else:
        value = -40.0 + 10.0 * torch.randn(B, T_x, T_y, generator=g)
    mask = ((torch.arange(T_x)[None, :, None] < t_xs[:, None, None])
            & (torch.arange(T_y)[None, None, :] < t_ys[:, None, None])).float()
    if case == "zeroed_cell":
        mask[:, 1:, 1:] *= (torch.rand(B, T_x - 1, T_y - 1, generator=g)
                            > 0.05).float()
    return value.to(dev), mask.to(dev)


def mas_phase(dev):
    from tts_tpu_torch.ops.cuda import mas as MAS
    from tts_tpu_torch.ops.mas import maximum_path_torch

    res = dict(ms=None, plain_ms=None, library_ms=None)
    for case in ("random", "ties", "zeroed_cell"):
        value, mask = mas_inputs(dev, case)
        got = MAS.maximum_path_cuda(value, mask)
        want = maximum_path_torch(value, mask)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"MAS kernel path differs from the plain version at "
                f"{int((got != want).sum())} cells ({case})")
        if case != "zeroed_cell":   # there the path is masked too
            assert torch.equal(got.sum(dim=1), mask[:, 0, :])
        err = float((got - want).abs().max())
        ms = cuda_time_ms(lambda: MAS.maximum_path_cuda(value, mask), 20)
        plain_ms = cuda_time_ms(lambda: maximum_path_torch(value, mask), 2,
                                warmup=1)
        # device time by kernel function over one wrapper call: everything
        # the call puts on the card
        profile = kernel_profile(lambda: MAS.maximum_path_cuda(value, mask))
        B, T_x, T_y = value.shape
        cells = int((mask[:, :, :1] * mask[:, :1, :] > 0).sum())
        # the function's own traffic: value read inside the lengths, the
        # whole mask read, the whole path written (the kernel's decision
        # scratch is its own choice, not counted); three fp32 operations per
        # cell inside the lengths
        bound = bound_ms(4 * cells + (4 + 4) * B * T_x * T_y, 3.0 * cells)
        t_y = int((mask[:, 0, :] > 0).sum(dim=1).max())
        floor_ms = t_y * MAS_CYCLES_PER_COLUMN / SM_CLOCK_HZ * 1e3
        log({"kernel": MAS.KERNEL, "case": case, "kernel_ms": ms,
             "plain_ms": plain_ms, "library_ms": None,
             "bound_ms": bound[0], "bound_by": bound[1],
             "latency_floor_ms": floor_ms,
             "latency_floor": f"{t_y} columns x {MAS_CYCLES_PER_COLUMN} "
                              f"cycles at {SM_CLOCK_HZ / 1e9} GHz",
             "device_us_by_kernel": profile,
             "max_abs_err": err, "cells_in_lengths": cells,
             "shapes": f"B={B}, T_x={T_x}, T_y={T_y}"})
        if case == "random":
            res.update(ms=ms, plain_ms=plain_ms, bound=bound, err=err)
    return res


# ---------------------------------------------------------------------------
# phase 6: Glow-TTS training
# ---------------------------------------------------------------------------

SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "A large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.",
    "A pot of tea helps to pass the evening.",
]
N_UTTERANCES = 96
SAMPLE_RATE = 22050


def write_corpus(root: str, n: int = N_UTTERANCES) -> str:
    """LJSpeech layout: metadata.csv (id|text|text) and wavs/*.wav, ``n``
    utterances. Texts of 25-185 characters cut from the sentences at word
    boundaries; audio a gliding harmonic tone plus noise, len(text) / 15
    seconds within [1.5, 10]."""
    from tts_tpu_torch.audio.processor import write_wav

    rng = np.random.default_rng(SEED)
    words = " ".join(SENTENCES).split()
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, target in enumerate(np.linspace(25, 185, n)):
        start, text = (7 * i) % len(words), ""
        while len(text) < target - 4:
            text = (text + " " + words[start % len(words)]).strip()
            start += 1
        dur = float(np.clip(len(text) / 15.0, 1.5, 10.0))
        t = np.arange(int(dur * SAMPLE_RATE)) / SAMPLE_RATE
        f0 = rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * 0.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
        y = sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3))
        y = y + 0.03 * rng.standard_normal(len(t))
        name = f"LJ900-{i:04d}"
        write_wav(os.path.join(wav_dir, name + ".wav"), y.astype(np.float32),
                  SAMPLE_RATE)
        lines.append(f"{name}|{text}|{text}")
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return root


def training_phase(dev, root: str, card: str):
    from tts_tpu_torch.bin.train_glow_tts import main as train_main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models import glow_tts as G
    from tts_tpu_torch.models.glow.flows import ActNorm
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import mas as MAS
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train.checkpoint import latest_checkpoint
    from tts_tpu_torch.train.trainer_glow import batch_to_device

    here = os.path.dirname(os.path.abspath(__file__))
    corpus = write_corpus(os.path.join(root, "LJSpeech"))
    c = load_config(os.path.join(here, "configs", "glow_tts_ljspeech.json"))
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    c["phoneme_cache_path"] = os.path.join(root, "phoneme_cache")
    c["epochs"] = 2
    cfg_path = os.path.join(root, "glow_tts.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)

    # MAS's device time inside the training forward: events around each call
    mas_events = []
    plain_call = G.maximum_path

    def timed_maximum_path(value, mask):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = plain_call(value, mask)
        ev[1].record()
        mas_events.append((ev, tuple(value.shape)))
        return out

    G.maximum_path = timed_maximum_path
    try:
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_main(["--config_path", cfg_path, "--output_path",
                              os.path.join(root, "runs")])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        G.maximum_path = plain_call
    steps = trainer.global_step
    log({"training_launches": launches, "steps": steps})
    assert steps >= 2, steps
    assert launches.get(MAS.KERNEL, 0) == steps + 1, (launches, steps)
    losses = [s["loss"] for s in trainer.step_stats]
    assert len(losses) == steps and all(np.isfinite(losses)), losses

    # the parameters moved from their seeded init (ActNorms aside: DDI
    # sets those)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(c.get("seed", 54321))
        init = setup_model(num_symbols(c["use_phonemes"]), 1, c).state_dict()
    actnorm = {f"{n}.{k}" for n, m in trainer.model.named_modules()
               if isinstance(m, ActNorm) for k in ("logs", "bias")}
    moved = {n: float((p.detach().cpu() - init[n]).abs().max())
             for n, p in trainer.model.named_parameters() if n not in actnorm}
    n_moved = sum(d > 0 for d in moved.values())
    assert n_moved > 0, "no parameter changed"

    step_s = [s["step_time"] for s in trainer.step_stats]
    mas_ms = [ev[0].elapsed_time(ev[1]) for ev, _ in mas_events]
    log({"training": "glow_tts full width", "batch": c["batch_size"],
         "steps": steps, "losses": losses, "wall_s": wall_s,
         "ms_per_step_median_after_first": 1e3 * float(np.median(step_s[1:])),
         "ms_per_step": [1e3 * t for t in step_s],
         "loader_ms": [1e3 * s["loader_time"] for s in trainer.step_stats],
         "mas_ms_per_call": mas_ms,
         "mas_ms_per_step_median": float(np.median(mas_ms[1:])),
         "mas_shapes": [shape for _, shape in mas_events],
         "params_moved": f"{n_moved}/{len(moved)}",
         "max_param_change": max(moved.values()),
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "card": card})

    # the last checkpoint serves through the Synthesizer
    paths = build_models(root)
    synth = Synthesizer(latest_checkpoint(trainer.output_path), cfg_path,
                        paths["voc"], paths["vocoder_config"], device=dev)
    wav = synth.tts("The birch canoe slid on the smooth planks.")
    assert wav.ndim == 1 and np.isfinite(wav).all()
    assert np.abs(wav).max() > 1e-3, float(np.abs(wav).max())
    log({"served_from_training_checkpoint": True, "samples": len(wav),
         "peak": float(np.abs(wav).max())})

    # where a step's time goes, on one batch of the longest utterances:
    # device time between events, and the host's time to enqueue each part
    # (the optimizer's non-finite check waits for the device once)
    model, opt = trainer.model.train(), trainer.optimizer
    ds = trainer.dataset
    batch = batch_to_device(ds.collate([ds[i] for i in range(
        len(ds) - c["batch_size"], len(ds))]), dev)
    split = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = [0.0] * 4
        opt.zero_grad()
        torch.cuda.synchronize()
        host[0] = time.perf_counter()
        ev[0].record()
        out = model(batch["text"], batch["text_lengths"], batch["mel"],
                    batch["mel_lengths"])
        ev[1].record()
        host[1] = time.perf_counter()
        G.glow_tts_loss(out, batch["text_lengths"])["loss"].backward()
        ev[2].record()
        host[2] = time.perf_counter()
        opt.step()
        ev[3].record()
        host[3] = time.perf_counter()
        torch.cuda.synchronize()
        split.append(([ev[i].elapsed_time(ev[i + 1]) for i in range(3)],
                      [1e3 * (host[i + 1] - host[i]) for i in range(3)]))
    parts = ("forward_incl_mas", "loss_and_backward", "optimizer")
    log({"training_step_split_ms": {
            p: {"device": [d[i] for d, _ in split],
                "host_enqueue": [h[i] for _, h in split]}
            for i, p in enumerate(parts)},
         "batch_shapes": {"text": list(batch["text"].shape),
                          "mel": list(batch["mel"].shape)},
         "card": card})
    return {"launches": launches[MAS.KERNEL], "steps": steps}


# ---------------------------------------------------------------------------
# phase 7: GAN kernels (STFT magnitude, grouped-conv gradients)
# ---------------------------------------------------------------------------

GAN_BATCH, GAN_SEQ = 64, 16384          # configs/multiband_melgan.json
PWGAN_BATCH, PWGAN_SEQ = 6, 25600       # configs/parallel_wavegan.json
FULLBAND = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
SUBBAND = ((384, 30, 150), (683, 60, 300), (171, 10, 60))
# (B, C_in, L, C_out, groups) of down_0..2 at scale 0, kernel 41, stride 4
DISC_LAYERS = ((GAN_BATCH, 16, 16384, 64, 16), (GAN_BATCH, 64, 4096, 256, 64),
               (GAN_BATCH, 256, 1024, 1024, 256))
DX_TOL = 1e-5                           # absolute, about 44 products each


def gan_kernel_phase(dev):
    from tts_tpu_torch.ops import grouped_conv as GC
    from tts_tpu_torch.ops import stft as S
    from tts_tpu_torch.ops.cuda import grouped_conv_grad as GCK
    from tts_tpu_torch.ops.cuda import stft_mag as SK

    g = torch.Generator(dev).manual_seed(SEED)
    results = {}

    def stft_geometry(label, y, resolutions, res):
        """B5 against its plain version on ``y``'s frames at each
        resolution; logs each and adds its times, bytes and operations to
        ``res``."""
        for n_fft, hop, win in resolutions:
            fr = S.frames(y, n_fft, hop).reshape(-1, n_fft).contiguous()
            wr, wi = S.dft_banks(n_fft, win, dev)
            window, banks = S.half_banks(n_fft, win, dev)
            got = SK.stft_mag_cuda(fr, window, banks)
            want = S.stft_magnitude_torch(fr, wr, wi)
            err = check_close(SK.KERNEL, got, want)
            hann = torch.hann_window(win, device=dev)
            ms = cuda_time_ms(lambda: SK.stft_mag_cuda(fr, window, banks), 10)
            plain_ms = cuda_time_ms(
                lambda: S.stft_magnitude_torch(fr, wr, wi), 10)
            library_ms = cuda_time_ms(lambda: torch.stft(
                y, n_fft, hop, win, hann, center=True, pad_mode="reflect",
                return_complex=True).abs(), 10)
            N, K = fr.shape
            F_ = got.shape[1]
            # the function's least work: frames, window and banks in and
            # magnitudes out once; a real FFT's ~2.5 K log2 K operations a
            # frame. tf32_gflop: the kernel's folded (N x G) x (G x G)
            # products (four after a radix-2 step, else two), three TF32
            # terms each
            nb = nbytes(fr, window, banks, got)
            fl = 2.5 * N * K * math.log2(K) + 4.0 * N * F_
            G = S.fold_size(K)
            tf32_fl = 3 * (4 if S.radix2(K) else 2) * 2.0 * N * G * G
            log({"kernel": SK.KERNEL, "geometry": label, "n_fft": n_fft,
                 "hop": hop, "win": win, "signal": list(y.shape),
                 "frames": N, "bins": F_, "kernel_ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound_ms(nb, fl)[0], "bound_mb": nb / 1e6,
                 "tf32_gflop": tf32_fl / 1e9,
                 "tf32_tflops": tf32_fl / ms / 1e9,
                 "max_abs_err": err, "max_mag": float(want.abs().max())})
            res["err"] = max(res["err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms), ("nb", nb),
                             ("fl", fl)):
                res[key] += val

    # B5: one signal's six resolutions at MB-MelGAN's batch (the step runs
    # each twice: y_hat, y); the iSTFT MelGAN's full band is the same
    res = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nb=0, fl=0.0)
    signals = {"full": 0.3 * torch.randn(GAN_BATCH, GAN_SEQ, device=dev,
                                         generator=g),
               "sub": 0.3 * torch.randn(GAN_BATCH * 4, GAN_SEQ // 4,
                                        device=dev, generator=g)}
    for band, resolutions in (("full", FULLBAND), ("sub", SUBBAND)):
        stft_geometry(f"multiband_melgan_{band}", signals[band], resolutions,
                      res)
    # ...and the three full-band ones at ParallelWaveGAN's batch: few
    # blocks of rows, each with a ragged last tile. The kernels line keeps
    # the sum above; the largest error is over both geometries
    pw = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nb=0, fl=0.0)
    stft_geometry("parallel_wavegan", 0.3 * torch.randn(
        PWGAN_BATCH, PWGAN_SEQ, device=dev, generator=g), FULLBAND, pw)
    pw["bound"] = bound_ms(pw.pop("nb"), pw.pop("fl"))
    log({"kernel": SK.KERNEL, "summed_over": "parallel_wavegan's three "
         "full-band resolutions, one launch each", "kernel_ms": pw["ms"],
         "plain_ms": pw["plain_ms"], "library_ms": pw["library_ms"],
         "bound_ms": pw["bound"][0], "bound_by": pw["bound"][1],
         "max_abs_err": pw["err"]})
    res["err"] = max(res["err"], pw["err"])
    res["bound"] = bound_ms(res.pop("nb"), res.pop("fl"))
    results[SK.KERNEL] = res

    # the Function's backward (analytic, plain matmuls) against autograd
    # through the plain version, at one small resolution, on the card
    y = signals["sub"][:8].clone().requires_grad_()
    mag = S.stft_magnitude(y, 171, 10, 60)
    w = torch.randn(mag.shape, device=dev, generator=g)
    (mag * w).sum().backward()
    yp = y.detach().clone().requires_grad_()
    fr = S.frames(yp, 171, 10)
    plain = S.stft_magnitude_torch(fr.reshape(-1, 171),
                                   *S.dft_banks(171, 60, dev))
    (plain.reshape(mag.shape) * w).sum().backward()
    grad_err = check_close("stft_magnitude backward", y.grad, yp.grad)
    log({"stft_function_grad_vs_autograd_max_abs_err": grad_err,
         "max_grad": float(yp.grad.abs().max())})

    # B6: the three kernel layers of scale 0
    k, stride = 41, 4
    pad = (k - 1) // 2
    wres = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nb=0, fl=0.0)
    dres = dict(err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, nb=0, fl=0.0)
    for B, cin, L, cout, groups in DISC_LAYERS:
        x = torch.randn(B, cin, L, device=dev, generator=g)
        w = 0.1 * torch.randn(cout, 1, k, device=dev, generator=g)
        dy = torch.randn(B, cout, L // stride, device=dev, generator=g)
        shape = f"x ({B}, {cin}, {L}) -> dy ({B}, {cout}, {L // stride})"
        fl = 2.0 * cout * k * B * (L // stride)

        got = GCK.grouped_conv_wgrad_cuda(x, dy, k, stride, groups)
        want = GC.grouped_conv_wgrad_torch(x, dy, k, stride, groups)
        err = check_close(GCK.WGRAD, got, want)
        again = GCK.grouped_conv_wgrad_cuda(x, dy, k, stride, groups)
        assert torch.equal(got, again), "wgrad differs between two calls"
        r = dict(ms=cuda_time_ms(lambda: GCK.grouped_conv_wgrad_cuda(
                     x, dy, k, stride, groups), 10),
                 plain_ms=cuda_time_ms(lambda: GC.grouped_conv_wgrad_torch(
                     x, dy, k, stride, groups), 2, warmup=1),
                 library_ms=cuda_time_ms(
                     lambda: torch.nn.grad.conv1d_weight(
                         x, w.shape, dy, stride, pad, groups=groups), 10),
                 nb=nbytes(x, dy, got), fl=fl)
        log({"kernel": GCK.WGRAD, "shapes": shape, "kernel_ms": r["ms"],
             "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
             "bound_ms": bound_ms(r["nb"], fl)[0], "max_abs_err": err,
             "max_dw": float(want.abs().max()),
             "bitwise_equal_across_calls": True})
        wres["err"] = max(wres["err"], err)
        for key in ("ms", "plain_ms", "library_ms", "nb", "fl"):
            wres[key] += r[key]

        got = GCK.grouped_conv_dgrad_cuda(dy, w, L, stride, groups)
        want = GC.grouped_conv_dgrad_torch(dy, w, L, stride, groups)
        err = float((got - want).abs().max())
        if not err <= DX_TOL:
            raise AssertionError(f"{GCK.DGRAD}: max |err| {err} > {DX_TOL}")
        again = GCK.grouped_conv_dgrad_cuda(dy, w, L, stride, groups)
        assert torch.equal(got, again), "dgrad differs between two calls"
        r = dict(ms=cuda_time_ms(lambda: GCK.grouped_conv_dgrad_cuda(
                     dy, w, L, stride, groups), 10),
                 plain_ms=cuda_time_ms(lambda: GC.grouped_conv_dgrad_torch(
                     dy, w, L, stride, groups), 2, warmup=1),
                 library_ms=cuda_time_ms(
                     lambda: torch.nn.grad.conv1d_input(
                         x.shape, w, dy, stride, pad, groups=groups), 10),
                 nb=nbytes(dy, w, got), fl=fl)
        log({"kernel": GCK.DGRAD, "shapes": shape, "kernel_ms": r["ms"],
             "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
             "bound_ms": bound_ms(r["nb"], fl)[0], "max_abs_err": err,
             "max_dx": float(want.abs().max()),
             "bitwise_equal_across_calls": True})
        dres["err"] = max(dres["err"], err)
        for key in ("ms", "plain_ms", "library_ms", "nb", "fl"):
            dres[key] += r[key]
    for name, r in ((GCK.WGRAD, wres), (GCK.DGRAD, dres)):
        r["bound"] = bound_ms(r.pop("nb"), r.pop("fl"))
        results[name] = r
    for name, r in results.items():
        log({"kernel": name, "summed_over": "the path's shapes, one launch "
             "each", "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
             "library_ms": r["library_ms"], "bound_ms": r["bound"][0],
             "bound_by": r["bound"][1], "max_abs_err": r["err"]})
    return results


# ---------------------------------------------------------------------------
# phase 8: GAN vocoder training
# ---------------------------------------------------------------------------

GAN_EPOCHS = 4


def _timed_kernels(modules, names, events):
    """Wrap the kernel launchers ``names`` of ``modules`` with CUDA events;
    returns the originals to restore."""
    saved = []
    for mod, name in zip(modules, names):
        fn = getattr(mod, name)

        def timed(*args, _fn=fn, _name=name):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = _fn(*args)
            ev[1].record()
            events.append((_name, ev))
            return out
        setattr(mod, name, timed)
        saved.append((mod, name, fn))
    return saved


def gan_training_phase(dev, root: str, card: str):
    from tts_tpu_torch.bin.train_vocoder import main as train_main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.vocoder.registry import (setup_discriminator,
                                                       setup_generator)
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import grouped_conv_grad as GCK
    from tts_tpu_torch.ops.cuda import stft_mag as SK
    from tts_tpu_torch.train.checkpoint import latest_checkpoint
    from tts_tpu_torch.train.trainer_vocoder import batch_to_device

    here = os.path.dirname(os.path.abspath(__file__))
    corpus = write_corpus(os.path.join(root, "LJSpeech"))
    c = load_config(os.path.join(here, "configs", "multiband_melgan.json"))
    c["data_path"] = os.path.join(corpus, "wavs")
    c["output_path"] = os.path.join(root, "runs")
    c["epochs"] = GAN_EPOCHS
    c["steps_to_start_discriminator"] = 1
    cfg_path = os.path.join(root, "multiband_melgan.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    trainer = train_main(["--config_path", cfg_path])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    steps = trainer.global_step
    d_steps = sum(s["train_disc"] for s in trainer.step_stats)
    expect = {SK.KERNEL: 12 * steps, GCK.DGRAD: 27 * d_steps,
              GCK.WGRAD: 18 * d_steps}
    log({"gan_training_launches": launches, "steps": steps,
         "steps_with_discriminator": d_steps, "expected": expect,
         "derivation": "stft_magnitude: 6 resolutions x (y_hat, y) = 12 per "
         "step; per discriminator step, down_0..2 of 3 scales = 9 kernel "
         "layers: generator update 9 input gradients (D frozen: no weight "
         "gradient; the real audio needs none), discriminator update 2 "
         "applications x 9 input gradients (conv_in's weights need down_0's) "
         "and 2 x 9 weight gradients"})
    assert steps == GAN_EPOCHS and d_steps == GAN_EPOCHS - 1, (steps, d_steps)
    for name, n in expect.items():
        assert launches.get(name, 0) == n, (name, launches, expect)
    for stats in trainer.step_stats:
        values = [v for k, v in stats.items() if k.startswith(("G_", "D_"))]
        assert values and all(np.isfinite(values)), stats

    # both networks moved from their seeded init
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(c.get("seed", 54321))
        init = {"G": setup_generator(c).state_dict(),
                "D": setup_discriminator(c).state_dict()}
    moved = {}
    for side, model in (("G", trainer.gen), ("D", trainer.disc)):
        diffs = [float((p.detach().cpu() - init[side][n]).abs().max())
                 for n, p in model.named_parameters()]
        moved[side] = f"{sum(d > 0 for d in diffs)}/{len(diffs)}"
        assert sum(d > 0 for d in diffs) > 0, f"no {side} parameter moved"

    step_s = [s["step_time"] for s in trainer.step_stats]
    log({"gan_training": "multiband_melgan full width",
         "batch": c["batch_size"], "seq_len": c["seq_len"],
         "mixed_precision": c["mixed_precision"], "steps": steps,
         "losses": [{k: v for k, v in s.items() if k.startswith(("G_", "D_"))}
                    for s in trainer.step_stats],
         "wall_s": wall_s,
         "ms_per_step_median_after_first":
             1e3 * float(np.median(step_s[1:])),
         "ms_per_step": [1e3 * t for t in step_s],
         "loader_ms": [1e3 * s["loader_time"] for s in trainer.step_stats],
         "params_moved": moved,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "card": card})

    # the last generator checkpoint serves through the Synthesizer
    paths = build_models(root)
    ckpt = latest_checkpoint(trainer.output_path)
    assert os.path.basename(ckpt) == f"checkpoint_{steps}.pt", ckpt
    synth = Synthesizer(paths["tts"], paths["tts_config"], ckpt, cfg_path,
                        device=dev)
    wav = synth.tts("The birch canoe slid on the smooth planks.")
    assert wav.ndim == 1 and np.isfinite(wav).all()
    assert np.abs(wav).max() > 1e-3, float(np.abs(wav).max())
    log({"served_from_gan_checkpoint": os.path.basename(ckpt),
         "samples": len(wav), "peak": float(np.abs(wav).max())})

    # where a step's time goes, on one G / D batch pair: device time between
    # events, the host's time to enqueue each part (each optimizer waits
    # for the card once), and the kernels' device time inside the step
    from tts_tpu_torch.ops import grouped_conv as GC
    from tts_tpu_torch.ops import stft as S
    step = trainer.step
    ds = trainer.dataset
    items = list(range(c["batch_size"]))
    bG = batch_to_device(ds.collate([ds[i] for i in items]), dev)
    bD = batch_to_device(ds.collate([ds[ds.G_to_D_mappings[i]]
                                     for i in items]), dev)
    parts = ("G_forward_and_loss", "G_backward", "G_optimizer",
             "D_forward_and_loss", "D_backward", "D_optimizer")
    kernel_events = []
    saved = _timed_kernels(
        (S.stft_cuda, GC.gc_cuda, GC.gc_cuda),
        ("stft_mag_cuda", "grouped_conv_wgrad_cuda",
         "grouped_conv_dgrad_cuda"), kernel_events)
    # the STFT magnitude's backward (plain matmuls: two to recompute re and
    # im, two for the frames' gradient), timed the same way; autograd looks
    # the Function's backward up on the class at each call
    stft_backward = S.StftMagnitudeFrames.backward

    def timed_stft_backward(ctx, grad):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = stft_backward(ctx, grad)
        ev[1].record()
        kernel_events.append(("stft_magnitude_backward_plain", ev))
        return out
    S.StftMagnitudeFrames.backward = staticmethod(timed_stft_backward)
    split = []
    try:
        for _ in range(3):
            kernel_events.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
            host = [0.0] * 7
            step.opt_G.zero_grad()
            step.opt_D.zero_grad()
            torch.cuda.synchronize()
            host[0] = time.perf_counter()
            ev[0].record()
            g_losses = step.generator_losses(bG, True)
            ev[1].record()
            host[1] = time.perf_counter()
            g_losses["G_loss"].backward()
            ev[2].record()
            host[2] = time.perf_counter()
            step.opt_G.step()
            ev[3].record()
            host[3] = time.perf_counter()
            d_losses = step.discriminator_losses(bD)
            ev[4].record()
            host[4] = time.perf_counter()
            d_losses["D_loss"].backward()
            ev[5].record()
            host[5] = time.perf_counter()
            step.opt_D.step()
            ev[6].record()
            host[6] = time.perf_counter()
            torch.cuda.synchronize()
            kernel_ms = {}
            for name, (a, b) in kernel_events:
                kernel_ms[name] = kernel_ms.get(name, 0.0) + a.elapsed_time(b)
            split.append(([ev[i].elapsed_time(ev[i + 1]) for i in range(6)],
                          [1e3 * (host[i + 1] - host[i]) for i in range(6)],
                          ev[0].elapsed_time(ev[6]), kernel_ms))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        S.StftMagnitudeFrames.backward = staticmethod(stft_backward)
    log({"gan_step_split_ms": {
            p: {"device": [d[i] for d, _, _, _ in split],
                "host_enqueue": [h[i] for _, h, _, _ in split]}
            for i, p in enumerate(parts)},
         "step_device_ms": [t for _, _, t, _ in split],
         "kernel_device_ms_per_step": [k for _, _, _, k in split],
         "stft_backward_device_ms_per_step": [
             k.get("stft_magnitude_backward_plain") for _, _, _, k in split],
         "card": card})
    return launches


# ---------------------------------------------------------------------------
# phase 9: Tacotron2 kernels (B7 encoder BiLSTM, B8 whole decode)
# ---------------------------------------------------------------------------

TACO_BATCH, TACO_TEXT, TACO_STEPS, TACO_R = 64, 128, 124, 2   # bench.py
TACO_SERVED_STEPS = 80     # the served config's step budget (phase 10)


def taco2_bench_model(dev):
    """bench.py's Tacotron2 (full width, r = 2, 128 symbols), seeded."""
    from tts_tpu_torch.models.tacotron2 import Tacotron2
    torch.manual_seed(SEED)
    return Tacotron2(num_chars=128, r=TACO_R).to(dev).eval()


def decode_flops(B: int, T: int, D: int, steps: int, p) -> float:
    """fp32 FLOPs of `steps` decode steps: the prenet, both LSTMs' fused
    products, the query projection, the location conv and dense layer, the
    energies (v . tanh), the context, the projection and the stop logit."""
    M, P1 = p["pw1"].shape
    P2 = p["pw2"].shape[1]
    H, A = p["qk"].shape
    KL, _, F = p["kloc"].shape
    per_item = (M * P1 + P1 * P2 + p["aw"].numel() + H * A
                + T * (KL * 2 * F + F * A + A + D)
                + p["dw"].numel() + p["projw"].numel() + p["stopw"].numel())
    return 2.0 * B * per_item * steps


def taco2_kernel_phase(dev):
    from tts_tpu_torch.infer.fast_decode import packed_weights
    from tts_tpu_torch.ops import bilstm as BL
    from tts_tpu_torch.ops import taco2_decode as TD
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK

    model = taco2_bench_model(dev)
    B, T = TACO_BATCH, TACO_TEXT
    g = torch.Generator(dev).manual_seed(1)
    text = torch.randint(0, 128, (B, T), device=dev, generator=g)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    lstm, packed, w_in = packed_weights(model)
    results = {}

    # B7 on the main path's input: the embedding through the conv stack
    with torch.no_grad():
        x = model.embedding(text).transpose(1, 2)
        for layer in model.encoder.convolutions:
            x = layer(x)
        x = x.transpose(1, 2).contiguous()
    got = BL.bilstm(x, lens, *lstm)
    want = BL.bilstm_torch(x, lens, *lstm)
    C, H = x.shape[2], lstm[0].shape[1] // 4
    # yardstick: cuDNN's bidirectional LSTM with the same weights
    cudnn = torch.nn.LSTM(C, H, batch_first=True, bidirectional=True).to(dev)
    cudnn.load_state_dict(model.encoder.lstm.state_dict())
    packed_x = torch.nn.utils.rnn.pack_padded_sequence(
        x, lens.cpu(), batch_first=True, enforce_sorted=False)

    def library():
        with torch.no_grad():
            return cudnn(packed_x)[0]
    lib_out, _ = torch.nn.utils.rnn.pad_packed_sequence(library(),
                                                        batch_first=True)
    results[BLK.KERNEL] = dict(
        err=check_close(BLK.KERNEL, got, want),
        ms=cuda_time_ms(lambda: BL.bilstm(x, lens, *lstm), 10),
        plain_ms=cuda_time_ms(lambda: BL.bilstm_torch(x, lens, *lstm), 2,
                              warmup=1),
        library_ms=cuda_time_ms(library, 10),
        bound=bound_ms(nbytes(x, got, *lstm),
                       2 * 2.0 * B * T * (C + H) * 4 * H))
    log({"kernel": BLK.KERNEL, "kernel_ms": results[BLK.KERNEL]["ms"],
         "plain_ms": results[BLK.KERNEL]["plain_ms"],
         "library_ms": results[BLK.KERNEL]["library_ms"],
         "bound_ms": results[BLK.KERNEL]["bound"][0],
         "bound_by": results[BLK.KERNEL]["bound"][1],
         "max_abs_err": results[BLK.KERNEL]["err"],
         "cudnn_vs_kernel_max_abs": float((lib_out - got).abs().max()),
         "launches_per_call": 1 + T,
         "shapes": f"B={B}, T={T}, C={C}, H={H} per direction"})

    # B8 on the main path's inputs: the kernel's encoder outputs, all valid
    enc = got
    pi = enc @ w_in
    mask = torch.ones(B, T, device=dev)
    short = 16
    got = TD.fused_decode(enc, pi, mask, packed, short, TACO_R)
    want = TD.decode_torch(enc, pi, mask, packed, short, TACO_R)
    err = max(check_close(f"{TDK.KERNEL} {name} ({short} steps)", a, b)
              for name, a, b in zip(("frames", "stop", "align"), got, want))
    full = TD.fused_decode(enc, pi, mask, packed, TACO_STEPS, TACO_R)
    ref = TD.decode_torch(enc, pi, mask, packed, TACO_STEPS, TACO_R)
    for t in full:
        assert torch.isfinite(t).all(), "non-finite decode output"
    drift = {name: float((a - b).abs().max()) for name, a, b in
             zip(("frames", "stop", "align"), full, ref)}
    flops = decode_flops(B, T, enc.shape[2], TACO_STEPS, packed)
    results[TDK.KERNEL] = dict(
        err=err,
        ms=cuda_time_ms(lambda: TD.fused_decode(enc, pi, mask, packed,
                                                TACO_STEPS, TACO_R), 3),
        plain_ms=cuda_time_ms(lambda: TD.decode_torch(
            enc, pi, mask, packed, TACO_STEPS, TACO_R), 1, warmup=1),
        library_ms=None,
        bound=bound_ms(nbytes(enc, pi, mask, *packed.values(), *full),
                       flops))
    r = results[TDK.KERNEL]
    log({"kernel": TDK.KERNEL, "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
         "library_ms": None, "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "max_abs_err": err,
         f"max_abs_dev_{TACO_STEPS}_steps": drift,
         f"max_abs_{TACO_STEPS}_steps": {
             name: float(t.abs().max())
             for name, t in zip(("frames", "stop", "align"), ref)},
         "gflop": flops / 1e9,
         "weights_mb": nbytes(*packed.values()) / 1e6,
         "launches_per_call": TDK.LAUNCHES_PER_STEP * TACO_STEPS,
         "shapes": f"B={B}, T={T}, {TACO_STEPS} steps, r={TACO_R}"})

    # where the time goes, by kernel: B7, then 16 decode steps at this
    # batch and at serving's (one item, a 64-symbol bucket, whose 80 steps
    # are also timed)
    one = [t[:1, :64].contiguous() for t in (enc, pi, mask)]
    serve_ms = cuda_time_ms(lambda: TD.fused_decode(*one, packed,
                                                    TACO_SERVED_STEPS,
                                                    TACO_R), 3)
    serve_out = TD.fused_decode(*one, packed, TACO_SERVED_STEPS, TACO_R)
    serve_bound = bound_ms(
        nbytes(*one, *packed.values(), *serve_out),
        decode_flops(1, 64, enc.shape[2], TACO_SERVED_STEPS, packed))
    log({"taco2_kernel_profile_us": {
            "bilstm": kernel_profile(lambda: BL.bilstm(x, lens, *lstm)),
            f"decode_B{B}_16_steps": kernel_profile(
                lambda: TD.fused_decode(enc, pi, mask, packed, 16, TACO_R)),
            "decode_B1_16_steps": kernel_profile(
                lambda: TD.fused_decode(*one, packed, 16, TACO_R))},
         f"decode_B1_T64_{TACO_SERVED_STEPS}_steps_ms": serve_ms,
         "decode_B1_bound_ms": serve_bound[0],
         "decode_B1_bound_by": serve_bound[1]})
    return results


# ---------------------------------------------------------------------------
# phase 10: Tacotron2 serving
# ---------------------------------------------------------------------------

def build_taco2(root: str):
    """Seeded full-width configs/tacotron2_ljspeech.json (r 7 with r_init 7,
    the DDC coarse decoder present) saved as a port checkpoint beside the
    served copy of its config. Random weights stop at random, so the
    stopnet is silenced (zero weights, bias -10), and the served config
    cuts the step budget to TACO_SERVED_STEPS (560 frames, 6.5 s of audio):
    the depth of the decode, not its width."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols

    here = os.path.dirname(os.path.abspath(__file__))
    c = load_config(os.path.join(here, "configs", "tacotron2_ljspeech.json"))
    c["max_decoder_steps"] = TACO_SERVED_STEPS
    torch.manual_seed(SEED)
    model = setup_model(num_symbols(c["use_phonemes"]), 1, c)
    stop = model.decoder.stopnet[1].linear_layer
    with torch.no_grad():
        stop.weight.zero_()
        stop.bias.fill_(-10.0)
    paths = {"taco2": os.path.join(root, "taco2.pt"),
             "taco2_config": os.path.join(root, "tacotron2.json")}
    torch.save({"model": model.state_dict()}, paths["taco2"])
    with open(paths["taco2_config"], "w") as f:
        json.dump(c, f)
    return paths, c


def first_divergence(a: np.ndarray, b: np.ndarray, r: int, tol=1e-4):
    """The decoder step where two (T, n_mels) mels first differ by more
    than `tol`, or None."""
    bad = np.nonzero(np.abs(a - b).max(axis=1) > tol)[0]
    return int(bad[0]) // r if len(bad) else None


def taco2_serving_phase(dev, root: str):
    from tts_tpu_torch.audio.processor import read_wav, wav_to_bytes
    from tts_tpu_torch.infer.fast_decode import supports_fused_decode
    from tts_tpu_torch.infer.synthesis import (bucket_text_length, synthesis,
                                               text_to_seqvec)
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK

    voc = build_models(root)
    paths, cfg = build_taco2(root)
    synth = Synthesizer(paths["taco2"], paths["taco2_config"], voc["voc"],
                        voc["vocoder_config"], device=dev)
    assert supports_fused_decode(synth.model) and synth.model.r == 7
    assert hasattr(synth.model, "coarse_decoder")
    assert synth._packed is not None, "vocoder must take the kernel chain"
    hop = synth.vocoder_ap.hop_length
    frames = TACO_SERVED_STEPS * synth.model.r
    expect = frames * hop + 10000          # mel bucket cut, sentence gap
    texts = ["Hello world!",
             "The birch canoe slid on the smooth planks.",
             "Four hours of steady work faced us, and the source of the huge "
             "river was clear."]
    build.reset_launches()
    served = []
    for text, (wav, ms) in zip(texts, served_wavs(synth, texts)):
        assert len(wav) == expect, (len(wav), expect)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        served.append(wav)
        log({"taco2_request": text[:40], "status": 200,
             "samples": len(wav), "mel_frames": frames, "latency_ms": ms})
    launches = dict(build.LAUNCHES)
    log({"taco2_main_path_launches": launches, "requests": len(texts)})
    buckets = [bucket_text_length(len(text_to_seqvec(t, cfg))) for t in texts]
    want = {BLK.KERNEL: sum(1 + b for b in buckets),
            TDK.KERNEL: len(texts) * TACO_SERVED_STEPS
            * TDK.LAUNCHES_PER_STEP}
    for name, n in want.items():
        assert launches.get(name, 0) == n, (name, launches.get(name), n)
    for name in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
        assert launches.get(name, 0) > 0, f"{name} was not launched"

    # the same requests on the CPU (plain versions) as the reference,
    # through the same 16-bit WAV encoding (1 LSB = 3.1e-5)
    cpu = Synthesizer(paths["taco2"], paths["taco2_config"], voc["voc"],
                      voc["vocoder_config"], device="cpu")
    errs, steps_apart = [], []
    for text, wav in zip(texts, served):
        ref, _ = read_wav(wav_to_bytes(cpu.tts(text), synth.ap.sample_rate))
        assert len(ref) == len(wav), (len(ref), len(wav))
        errs.append(float(np.abs(ref - wav).max()))
        mel_dev = synthesis(synth.model, text, cfg, dev)["postnet_outputs"]
        mel_cpu = synthesis(cpu.model, text, cfg,
                            torch.device("cpu"))["postnet_outputs"]
        steps_apart.append(first_divergence(mel_dev, mel_cpu, 7))
    log({"taco2_served_vs_cpu_max_abs_err": errs,
         "first_step_mel_differs_by_1e-4": steps_apart})
    assert max(errs) < 1e-3, errs

    # where a warm request's time goes (B=1, without HTTP); both parts end
    # in a copy to the host, so the host clock sees the card's work
    for text in texts:
        t0 = time.perf_counter()
        mel = synthesis(synth.model, text, cfg, dev)
        t1 = time.perf_counter()
        synth._vocode(mel["postnet_outputs"])
        t2 = time.perf_counter()
        log({"taco2_request_breakdown": text[:40],
             "text_and_tacotron2_ms": (t1 - t0) * 1e3,
             "vocoder_ms": (t2 - t1) * 1e3})
    return launches


# ---------------------------------------------------------------------------
# phase 11: Tacotron2 batched throughput
# ---------------------------------------------------------------------------

def taco2_batched_phase(dev, card: str):
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.fast_decode import (packed_weights,
                                                 taco2_fused_inference)
    from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.taco2_decode import fused_decode

    here = os.path.dirname(os.path.abspath(__file__))
    model = taco2_bench_model(dev)
    torch.manual_seed(SEED)
    voc = setup_generator(load_config(os.path.join(here, "configs",
                                                   "multiband_melgan.json")))
    sd = fold_weight_norm(voc.state_dict())
    vpacked = M.pack_generator_params(voc, sd, dev)
    B, T = TACO_BATCH, TACO_TEXT
    g = torch.Generator(dev).manual_seed(1)
    text = torch.randint(0, 128, (B, T), device=dev, generator=g)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    frames = TACO_STEPS * TACO_R

    def run():
        out = taco2_fused_inference(model, text, lens, TACO_STEPS)
        return M.megakernel_generator_apply(
            voc, vpacked, out["postnet_outputs"].contiguous())

    wav = run()
    torch.cuda.synchronize()
    assert wav.shape == (B, frames * 256, 1), wav.shape
    assert torch.isfinite(wav).all()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[1]

    # the split of one batch, device time between events: the encoder
    # (embedding, convs, B7, input projection), the decode (B8), the
    # postnet with the stop masking, the vocoder
    split = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        lstm, packed, w_in = packed_weights(model)
        with torch.no_grad():
            enc, mask = model.encode(text, lens, mask_pads=True,
                                     packed_lstm=lstm)
            pi = enc @ w_in
        ev[1].record()
        fr, stops, aligns = fused_decode(enc, pi, mask, packed, TACO_STEPS,
                                         TACO_R)
        ev[2].record()
        with torch.no_grad():
            out = model.finish(fr.transpose(0, 1).reshape(B, frames, 80),
                               stops.t(), aligns.transpose(0, 1))
        ev[3].record()
        M.megakernel_generator_apply(voc, vpacked,
                                     out["postnet_outputs"].contiguous())
        ev[4].record()
        torch.cuda.synchronize()
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    audio_s = B * frames * 256 / 22050
    log({"batched": "tacotron2 fused (B7, B8) + megakernel", "batch": B,
         "t_text": T, "steps": TACO_STEPS, "r": TACO_R, "mel_frames": frames,
         "s_per_batch": dt, "audio_s_per_s": audio_s / dt,
         "spread_pct": 100 * (times[-1] - times[0]) / dt,
         "split_ms": {p: [s[i] for s in split] for i, p in enumerate(
             ("encoder", "decode", "postnet", "vocoder"))},
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "card": card})


# ---------------------------------------------------------------------------
# phase 12: the fused Glow encoder (B3)
# ---------------------------------------------------------------------------

# (B, T, lengths): bench.py's batched geometry, the serving bucket of an
# 80-symbol sentence, and a ragged batch
GLOW_ENC_GEOMETRIES = ((128, 128, "all"), (1, 96, (80,)), (16, 192, (40, 192)))


def seed_encoder(enc, seed: int):
    """Refill every parameter of a port GlowTTSEncoder from the seed:
    fan-in scaled weights, LayerNorm scales near 1, small biases. Nothing
    stays zero, so the prenet's zero-initialised projection (and the LN
    scales' 0.1) cannot hide a wrong prenet."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if name.endswith("gamma"):
                v = 1.0 + 0.1 * torch.randn(p.shape, generator=g)
            elif p.dim() == 1:
                v = 0.05 * torch.randn(p.shape, generator=g)
            else:
                fan_in = p.shape[-1] if "emb_rel" in name else p[0].numel()
                v = torch.randn(p.shape, generator=g) / fan_in ** 0.5
            p.copy_(v)
    return enc


def glow_encoder_flops(d, lengths) -> float:
    """fp32 FLOPs of the encoder on the valid rows (and, in attention, the
    valid query-key pairs) of items of `lengths`: prenet convs and
    projection; per layer q|k|v, scores, band logits, softmax-weighted
    values and the value band, output projection, the two FFN convs; the
    mean projection; the duration predictor."""
    C, kc = d.hidden, d.hidden // d.heads
    rows = float(sum(lengths))
    pairs = float(sum(n * n for n in lengths))
    per_row = (d.n_pre * d.k_pre * C * C + C * C
               + d.layers * (3 * C * C + C * C + 2 * d.k_ffn * C * d.filt
                             + 2 * 9 * C)
               + C * d.n_out + d.k_dp * C * d.filt_dp
               + d.k_dp * d.filt_dp * d.filt_dp + d.filt_dp)
    return 2.0 * (rows * per_row + d.layers * pairs * 2 * C)


def glow_encoder_kernel_phase(dev):
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.ops import glow_encoder as GE
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.text import num_symbols

    here = os.path.dirname(os.path.abspath(__file__))
    c = load_config(os.path.join(here, "configs", "glow_tts_ljspeech.json"))
    torch.manual_seed(SEED)
    model = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    seed_encoder(model.encoder, SEED)
    model = model.to(dev).eval()
    enc = model.encoder
    assert GE.supports_fused_encoder(enc)
    packed = enc.packed_weights()
    d = packed.dims
    g = torch.Generator(dev).manual_seed(2)
    res = {}
    for B, T, lens in GLOW_ENC_GEOMETRIES:
        if lens == "all":
            lengths = torch.full((B,), T, device=dev)
        elif len(lens) == 1:
            lengths = torch.full((B,), lens[0], device=dev)
        else:
            lengths = torch.randint(lens[0], lens[1] + 1, (B,), device=dev,
                                    generator=g)
            lengths[0] = T
        text = torch.randint(1, enc.emb.num_embeddings, (B, T), device=dev,
                             generator=g)
        with torch.no_grad():
            emb = (enc.emb(text) * math.sqrt(d.hidden)).contiguous()
        mask = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        before = build.LAUNCHES[GEK.KERNEL]
        got = GEK.glow_encoder_cuda(packed.flat, d, emb, mask)
        launches = build.LAUNCHES[GEK.KERNEL] - before
        want = GE.glow_encoder_torch(packed, emb, mask)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "non-finite encoder output"
        err = check_close(f"{GEK.KERNEL} B={B} T={T}", got, want)
        assert not got[mask == 0].any(), "padded rows must be exactly 0"
        assert launches == GEK.launches_per_call(d), launches
        ms = cuda_time_ms(lambda: GEK.glow_encoder_cuda(packed.flat, d, emb,
                                                        mask), 10)
        plain_ms = cuda_time_ms(lambda: GE.glow_encoder_torch(packed, emb,
                                                              mask), 3)
        flops = glow_encoder_flops(d, lengths.tolist())
        bound = bound_ms(nbytes(emb, mask, packed.flat, got), flops)
        log({"kernel": GEK.KERNEL, "shapes": f"B={B}, T={T}",
             "lengths": [int(lengths.min()), int(lengths.max())],
             "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": None,
             "bound_ms": bound[0], "bound_by": bound[1], "gflop": flops / 1e9,
             "weights_mb": nbytes(packed.flat) / 1e6, "max_abs_err": err,
             "max_abs_plain": float(want.abs().max()),
             "launches_per_call": launches,
             "profile_us": kernel_profile(lambda: GEK.glow_encoder_cuda(
                 packed.flat, d, emb, mask))})
        if (B, T) == GLOW_ENC_GEOMETRIES[0][:2]:
            res = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound,
                       library_ms=None)
        else:
            res["err"] = max(res["err"], err)

    # the longest text B3's attention block holds (exported by the kernel's
    # source): GlowTTS.encode runs B3 up to it and the module above it
    limit = GE.fused_encoder_max_length(enc, dev)
    for T in (limit, limit + 1):
        text = torch.randint(1, enc.emb.num_embeddings, (1, T), device=dev,
                             generator=g)
        lengths = torch.full((1,), T, device=dev)
        before = build.LAUNCHES[GEK.KERNEL]
        with torch.no_grad():
            got = model.encode(text, lengths)
            torch.cuda.synchronize()
            launches = build.LAUNCHES[GEK.KERNEL] - before
            want = enc(text, lengths)
        assert launches == (GEK.launches_per_call(d) if T <= limit else 0), \
            (T, limit, launches)
        err = max(check_close(f"encode T={T}", a, b)
                  for a, b in zip(got[:3], want[:3]))
        log({"glow_encode_length_limit": limit, "T": T,
             "b3_launches": launches, "vs_module_max_abs_err": err})
    return res


# ---------------------------------------------------------------------------
# phase 13: the synthesis CLI
# ---------------------------------------------------------------------------

def cli_phase(dev, root: str):
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import text_to_seqvec
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK

    paths = build_models(root)
    cfg = load_config(paths["tts_config"])
    hop = cfg["audio"]["hop_length"]
    per_call = encoder_launches(Synthesizer(paths["tts"], paths["tts_config"],
                                            device=dev).model, ["x"])
    vocoder = ["--vocoder_path", paths["voc"],
               "--vocoder_config_path", paths["vocoder_config"]]
    runs = (("vocoder", "The birch canoe slid on the smooth planks.", vocoder),
            ("griffin_lim", "Hello world!", []))
    wavs = {}
    for name, text, extra in runs:
        frames = -(-6 * len(text_to_seqvec(text, cfg)) // 2) * 2
        if extra:   # the vocoder's mel bucket cut (serving_phase's rule)
            expect = frames * hop if frames % 32 else (frames + 4) * hop
        else:       # Griffin-Lim's inverse STFT of `frames` frames
            expect = (frames - 1) * hop
        build.reset_launches()
        t0 = time.perf_counter()
        path = synthesize([text, paths["tts_config"], paths["tts"],
                           os.path.join(root, "cli_" + name), *extra])
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        wav, sr = read_wav(path)
        assert sr == cfg["audio"]["sample_rate"]
        assert len(wav) == expect + 10000, (name, len(wav), expect + 10000)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        assert launches.get(GEK.KERNEL, 0) == per_call, launches
        for kernel in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
            assert (launches.get(kernel, 0) > 0) == bool(extra), (name,
                                                                  launches)
        wavs[name] = wav
        log({"cli": name, "file": os.path.basename(path),
             "samples": len(wav), "seconds_with_load": seconds,
             "launches": launches})

    # the vocoder run on the CPU (plain versions) as the reference
    cpu_path = synthesize([runs[0][1], paths["tts_config"], paths["tts"],
                           os.path.join(root, "cli_cpu"), *vocoder,
                           "--device", "cpu"])
    ref, _ = read_wav(cpu_path)
    assert len(ref) == len(wavs["vocoder"])
    err = float(np.abs(ref - wavs["vocoder"]).max())
    log({"cli_vocoder_vs_cpu_max_abs_err": err})
    assert err < 1e-3, err


# ---------------------------------------------------------------------------
# phase 14: Tacotron2 training
# ---------------------------------------------------------------------------

# configs/tacotron2_ljspeech.json's gradual schedule with its step
# boundaries (10,000 and 50,000) moved to 3 and 6: each r runs in a few
# epochs of the 96-utterance corpus (depth, not width)
TACO_TRAIN_BOUNDARIES = (0, 3, 6)
TACO_TRAIN_EPOCHS = 7
TACO_TEST_STEPS = 80       # the test sentences' decode budget (phase 10's)
BF16_TOL = 5e-3            # first step's losses, bf16 against fp32, relative
# the first step's decoder and postnet outputs, bf16 against fp32, as
# ||bf16 - fp32|| / ||fp32||: above an eighth of bf16's unit roundoff
# (2^-9), so a run that stayed float32 fails, and below 5e-2
BF16_OUT_RANGE = (2.0 ** -12, 5e-2)


def taco2_step_split(trainer, batch, r: int, reps: int = 3):
    """Where one training step's time goes on `batch` at `r`: device time
    between events and the host's enqueue time of the forward with the
    loss, the backward and the optimizer; torch.profiler's device time by
    kernel over one more step (busiest first), and the share of a step
    (median between events) in which no kernel runs."""
    from tts_tpu_torch.losses.tts_losses import tacotron_loss
    from tts_tpu_torch.train.trainer_tts import forward

    model, opt = trainer.model.train(), trainer.optimizer
    model.set_r(r)
    kw = dict(trainer.loss_kwargs, r=r)

    def step(marks=None):
        opt.zero_grad()
        loss = tacotron_loss(forward(model, batch, trainer.dtype), batch,
                             **kw)["loss"]
        if marks:
            marks()
        loss.backward()
        if marks:
            marks()
        opt.step()

    split = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = []

        def mark():
            ev[len(host)].record()
            host.append(time.perf_counter())
        torch.cuda.synchronize()
        mark()
        step(mark)
        mark()
        torch.cuda.synchronize()
        split.append(([ev[i].elapsed_time(ev[i + 1]) for i in range(3)],
                      [1e3 * (host[i + 1] - host[i]) for i in range(3)]))
    step_ms = float(np.median([sum(d) for d, _ in split]))
    parts = ("forward_and_loss", "backward", "optimizer")
    return {"r": r, "batch": list(batch["mel"].shape),
            "split_ms": {p: {"device": [d[i] for d, _ in split],
                             "host_enqueue": [h[i] for _, h in split]}
                         for i, p in enumerate(parts)},
            **busy_summary(kernel_profile(step), step_ms, 12)}


def taco2_training_phase(dev, root: str, card: str):
    from tts_tpu_torch.bin.train_tts import main as train_main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import (bucket_text_length, run_model,
                                               text_to_seqvec)
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.losses.tts_losses import tacotron_loss
    from tts_tpu_torch.models.layers import BatchNorm1d
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK
    from tts_tpu_torch.train.checkpoint import latest_checkpoint
    from tts_tpu_torch.train.trainer_tts import (TTSTrainer, batch_to_device,
                                                 forward)

    here = os.path.dirname(os.path.abspath(__file__))
    corpus = write_corpus(os.path.join(root, "LJSpeech"))
    c = load_config(os.path.join(here, "configs", "tacotron2_ljspeech.json"))
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    c["phoneme_cache_path"] = os.path.join(root, "phoneme_cache")
    c["gradual_training"] = [[start] + list(entry[1:]) for start, entry in
                             zip(TACO_TRAIN_BOUNDARIES,
                                 c["gradual_training"])]
    c["epochs"] = TACO_TRAIN_EPOCHS
    c["test_delay_epochs"] = TACO_TRAIN_EPOCHS - 1
    c["max_decoder_steps"] = TACO_TEST_STEPS
    cfg_path = os.path.join(root, "tacotron2_train.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    assert c["mixed_precision"] and c["double_decoder_consistency"]

    # the first batch's losses in bfloat16 against float32: one seeded
    # model, the same dropout masks (drawn in float32 from one state)
    probe = TTSTrainer(c, os.path.join(root, "probe"), device=dev)
    init = {k: v.detach().clone() for k, v in
            probe.model.state_dict().items()}
    r0, bs0 = c["gradual_training"][0][1:3]
    ds = probe.dataset(is_eval=False, r=r0)
    batch = batch_to_device(next(iter(ds.batches(bs0, shuffle=True,
                                                 seed=0))), dev)
    state = probe.generator.get_state()
    first, outs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        probe.generator.set_state(state)
        with torch.no_grad():
            outs[dtype] = forward(probe.model.train(), batch, dtype)
            first[str(dtype)] = {k: float(v) for k, v in tacotron_loss(
                outs[dtype], batch, **probe.loss_kwargs, r=r0).items()}
    f32, b16 = first["torch.float32"], first["torch.bfloat16"]
    rel = {k: abs(b16[k] - f32[k]) / abs(f32[k]) for k in f32}
    out_rel = {k: float((outs[torch.bfloat16][k] - v).norm() / v.norm())
               for k, v in outs[torch.float32].items()}
    log({"taco2_first_step_losses": first, "bf16_vs_fp32_rel": rel,
         "bf16_vs_fp32_outputs_rel_norm": out_rel,
         "batch_shapes": {"text": list(batch["text"].shape),
                          "mel": list(batch["mel"].shape)}})
    assert all(v <= BF16_TOL for v in rel.values()), rel
    lo, hi = BF16_OUT_RANGE
    assert all(lo < out_rel[k] < hi for k in
               ("decoder_outputs", "postnet_outputs")), out_rel
    del probe, batch, outs

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    trainer = train_main(["--config_path", cfg_path, "--output_path",
                          os.path.join(root, "runs")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fit_launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = trainer.step_stats
    rs = [s["r"] for s in stats]
    assert set(rs) == {7, 4, 2}, rs
    assert all(np.isfinite(v) for s in stats for v in s.values()), stats

    # every trained tensor moved but the coarse decoder's stopnet, whose
    # logits no loss reads (in tts_tpu neither); the tensors held fixed did
    # not; the BatchNorm running statistics moved
    moved, fixed = {}, []
    for name, p in trainer.model.named_parameters():
        delta = float((p.detach() - init[name]).abs().max())
        if not p.requires_grad:
            assert delta == 0.0, name
            fixed.append(name)
        elif not name.startswith("coarse_decoder.stopnet"):
            moved[name] = delta
    still = [n for n, d in moved.items() if d == 0.0]
    assert not still, still
    assert any(n.startswith("encoder.lstm.") for n in moved)
    bn = [m for m in trainer.model.modules() if isinstance(m, BatchNorm1d)]
    bn_names = [n for n, m in trainer.model.named_modules()
                if isinstance(m, BatchNorm1d)]
    bn_still = [n for n, m in zip(bn_names, bn) if torch.equal(
        m.running_var, init[f"{n}.running_var"])]
    assert bn and not bn_still, bn_still
    assert all(m.running_mean.dtype == m.running_var.dtype == torch.float32
               for m in bn), "BatchNorm statistics left float32"
    per_r = {}
    for r in sorted(set(rs), reverse=True):
        times = [1e3 * s["step_time"] for s in stats if s["r"] == r]
        per_r[r] = {"steps": len(times),
                    "batch": [s["batch_size"] for s in stats
                              if s["r"] == r][0],
                    "ms_per_step": times,
                    "ms_median_after_first": float(np.median(times[1:]))}
    log({"training": "tacotron2 full width (configs/tacotron2_ljspeech."
                     "json: DDC, bf16 mixed precision, phonemes)",
         "schedule": c["gradual_training"], "epochs": c["epochs"],
         "steps": len(stats), "r_per_step": rs, "wall_s": wall_s,
         "per_r": per_r,
         "loader_ms": [1e3 * s["loader_time"] for s in stats],
         "losses": [s["loss"] for s in stats],
         "params_moved": f"{len(moved)}/{len(moved)} trained "
                         f"(+{len(fixed)} held fixed, coarse stopnet aside)",
         "bn_buffers_moved": f"{len(bn)}/{len(bn)}",
         "min_param_change": min(moved.values()),
         "fit_launches": fit_launches, "peak_mem_gb": peak_gb,
         "card": card})

    # the test sentences at the trained r: B7 once per sentence (1 + the
    # text bucket launches), B8 for the whole budget (8 a step)
    sentences = c.get("test_sentences") or TTSTrainer.DEFAULT_TEST_SENTENCES
    buckets = [bucket_text_length(len(text_to_seqvec(s, c)))
               for s in sentences]
    build.reset_launches()
    audios = trainer.test_run()
    test_launches = dict(build.LAUNCHES)
    want = {BLK.KERNEL: sum(1 + b for b in buckets),
            TDK.KERNEL: len(sentences) * TACO_TEST_STEPS
            * TDK.LAUNCHES_PER_STEP}
    log({"taco2_test_run_launches": test_launches, "sentences": len(sentences),
         "text_buckets": buckets, "r": trainer.r,
         "samples": [len(a) for a in audios.values()]})
    for name, n in want.items():
        assert test_launches.get(name, 0) == n, (name, test_launches, n)
    assert all(np.isfinite(a).all() for a in audios.values())

    # the last checkpoint served with the Multiband-MelGAN vocoder
    voc = build_models(root)
    ckpt = latest_checkpoint(trainer.output_path)
    synth = Synthesizer(ckpt, cfg_path, voc["voc"], voc["vocoder_config"],
                        device=dev)
    assert synth.model.r == trainer.r
    text = "The birch canoe slid on the smooth planks."
    build.reset_launches()
    wav = synth.tts(text)
    served = dict(build.LAUNCHES)
    bucket = bucket_text_length(len(text_to_seqvec(text, c)))
    assert served.get(BLK.KERNEL, 0) == 1 + bucket, served
    assert served.get(TDK.KERNEL, 0) == (TACO_TEST_STEPS
                                         * TDK.LAUNCHES_PER_STEP), served
    for name in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
        assert served.get(name, 0) > 0, f"{name} was not launched"
    assert np.isfinite(wav).all()

    # the fast path (B7, B8) against the plain decode on the trained weights
    seq = torch.from_numpy(text_to_seqvec(text, c).astype(np.int64))[None]
    seq = seq.to(dev)
    # per step: the (stop-masked) frames, the stop logit and the alignment
    fast = run_model(synth.model, seq, c)
    plain = synth.model.inference(seq, max_decoder_steps=TACO_TEST_STEPS)
    per_step = [
        (fast["decoder_outputs"] - plain["decoder_outputs"]).abs()[0]
        .reshape(TACO_TEST_STEPS, -1).amax(1),
        (fast["stop_logits"] - plain["stop_logits"]).abs()[0],
        (fast["alignments"] - plain["alignments"]).abs()[0].amax(1)]
    per_step = torch.stack(per_step).amax(0).cpu().numpy()
    bad = np.nonzero(per_step > 1e-4)[0]
    apart = int(bad[0]) if len(bad) else None
    log({"taco2_trained_served_launches": served, "samples": len(wav),
         "fast_vs_plain_first_step_differs_by_1e-4": apart,
         "fast_vs_plain_max_abs_16_steps": float(per_step[:16].max()),
         "fast_vs_plain_max_abs_all_steps": float(per_step.max()),
         "mel_lengths": [int(fast["mel_lengths"][0]),
                         int(plain["mel_lengths"][0])]})
    assert apart is None or apart >= 16, apart

    # where a step's time goes, on the longest batch at the first and the
    # last r of the schedule
    splits = []
    for _, r, bs in (c["gradual_training"][0], c["gradual_training"][-1]):
        ds = trainer.dataset(is_eval=False, r=r)
        batch = batch_to_device(ds.collate([ds[i] for i in range(
            len(ds) - bs, len(ds))]), dev)
        splits.append(taco2_step_split(trainer, batch, r))
    log({"taco2_training_step_split": splits, "card": card})
    return {"test_run": test_launches, "per_r": per_r}


# ---------------------------------------------------------------------------
# phase 15: the first request of a cold server, with and without --prewarm
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the server with --prewarm cut to the smallest text bucket
PREWARM_ONE_BUCKET = (
    "import sys\n"
    "from tts_tpu_torch.infer.synthesizer import Synthesizer\n"
    "from tts_tpu_torch.server.server import main\n"
    "full = Synthesizer.prewarm\n"
    "Synthesizer.prewarm = lambda self: full(self, buckets=[32])\n"
    "main(sys.argv[1:])\n")


def prewarm_phase(root: str, card: str):
    """Phase 3's checkpoints served by the server in a process of its own,
    without --prewarm, with it over the smallest text bucket alone (the
    request's is larger) and with it as shipped: the seconds to listening,
    the prewarm's own, and the first and second requests' latency."""
    import queue

    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import (bucket_text_length,
                                               text_to_seqvec)

    here = os.path.dirname(os.path.abspath(__file__))
    paths = build_models(root)
    text = "The birch canoe slid on the smooth planks."
    bucket = bucket_text_length(len(text_to_seqvec(
        text, load_config(paths["tts_config"]))))
    assert bucket > 32, bucket
    server = ["-m", "tts_tpu_torch.server.server"]
    results = {}
    for name, entry, flags in (
            ("cold", server, []),
            ("prewarm_bucket_32", ["-c", PREWARM_ONE_BUCKET], ["--prewarm"]),
            ("prewarm", server, ["--prewarm"])):
        port = _free_port()
        cmd = [sys.executable, *entry,
               "--tts_checkpoint", paths["tts"],
               "--tts_config", paths["tts_config"],
               "--vocoder_checkpoint", paths["voc"],
               "--vocoder_config", paths["vocoder_config"],
               "--port", str(port), *flags]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines: "queue.Queue" = queue.Queue()

        def read(stream=proc.stdout, sink=lines):
            for line in stream:
                sink.put(line)
            sink.put(None)
        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        out, prewarm_s = [], None
        try:
            while True:
                line = lines.get(timeout=600)
                assert line is not None, "server exited:\n" + "".join(out)
                out.append(line)
                m = re.search(r"Prewarmed .* in ([0-9.]+)s", line)
                if m:
                    prewarm_s = float(m.group(1))
                if "Serving on" in line:
                    break
            listen_s = time.perf_counter() - t0
            url = (f"http://127.0.0.1:{port}/api/tts?"
                   + urllib.parse.urlencode({"text": text}))
            ms = []
            for _ in range(2):
                t1 = time.perf_counter()
                with urllib.request.urlopen(url, timeout=300) as r:
                    assert r.status == 200 and r.read(4) == b"RIFF"
                    r.read()
                ms.append(1e3 * (time.perf_counter() - t1))
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            reader.join(timeout=30)
        assert (prewarm_s is not None) == bool(flags), out
        results[name] = {"boot_to_listening_s": listen_s,
                         "prewarm_s": prewarm_s,
                         "first_request_ms": ms[0],
                         "second_request_ms": ms[1]}
    log({"server_first_request": results, "text": text,
         "request_bucket": bucket, "card": card})
    return results


# ---------------------------------------------------------------------------
# phases 16-17: ParallelWaveGAN and iSTFT MelGAN training
# ---------------------------------------------------------------------------

VOC_DISC_START = 2          # steps_to_start_discriminator (200,000 shipped)
PWGAN_UTTERANCES = 46       # 10 held out, 36 = 6 steps of batch 6
RWD_UTTERANCES = 22         # 10 held out, 12 = 2 steps of batch 6
ISTFT_EPOCHS = 4            # 86 training items at batch 64: a step an epoch
# the first batch's generator losses, bf16 against fp32, relative: the
# spectral convergence and adversarial terms within GAN_BF16_TOL; the
# log-magnitude term (and the total that holds it) is printed only: on a
# seeded generator's output it is decided by |STFT| bins at rounding level
# (tests/test_torch_port_gan_train.py), and bf16 moved it 13 % in a CPU
# rehearsal. The waveform ||bf16 - fp32|| / ||fp32|| above an eighth of
# bf16's unit roundoff (so a run that stayed float32 fails) and below 0.2
# (5.7e-2 in the CPU rehearsal at full width; 3e-3 at base 32, where the
# CPU tests hold the port's bf16 run to tts_tpu's)
GAN_BF16_TOL = 2e-2
GAN_BF16_HELD = ("G_stft_loss_sc", "G_mse_fake_loss")
GAN_BF16_OUT_RANGE = (2.0 ** -12, 0.2)


def conv_flops(module, *inputs) -> float:
    """Multiply-adds x 2 of every Conv1d / Conv2d / ConvTranspose1d /
    Linear in one call of ``module`` on ``inputs``, from the shapes that
    call gives them."""
    total = [0.0]

    def hook(m, args, out):
        if isinstance(m, torch.nn.ConvTranspose1d):
            per = m.out_channels // m.groups * m.kernel_size[0]
            total[0] += 2.0 * args[0].numel() * per
        elif isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d)):
            per = m.in_channels // m.groups * math.prod(m.kernel_size)
            total[0] += 2.0 * out.numel() * per
        elif isinstance(m, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * m.in_features
    kinds = (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose1d,
             torch.nn.Linear)
    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            module(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def gan_step_idle(trainer, reps: int = 3) -> dict:
    """``step_profile`` of one generator + discriminator step on a fixed
    batch pair."""
    from tts_tpu_torch.train.trainer_vocoder import batch_to_device

    ds, step, dev = trainer.dataset, trainer.step, trainer.device
    items = list(range(trainer.c["batch_size"]))
    bG = batch_to_device(ds.collate([ds[i] for i in items]), dev)
    bD = batch_to_device(ds.collate([ds[ds.G_to_D_mappings[i]]
                                     for i in items]), dev)
    return step_profile(lambda: step(bG, bD, True), reps, top=8)


def vocoder_training(dev, root: str, card: str, config: str, n_utterances: int,
                     label: str, **overrides):
    """Train ``config`` (full width, as shipped but for one epoch, the
    discriminator from step 2 and ``overrides``) on a synthetic corpus of
    ``n_utterances`` through bin/train_vocoder; assert
    the launch counts, finite losses and moved parameters; print the step
    times, loader wait, peak memory and the device's idle share. Returns
    (trainer, config path, launches)."""
    from tts_tpu_torch.bin.train_vocoder import main as train_main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.vocoder.registry import (setup_discriminator,
                                                       setup_generator)
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import grouped_conv_grad as GCK
    from tts_tpu_torch.ops.cuda import stft_mag as SK

    here = os.path.dirname(os.path.abspath(__file__))
    corpus = write_corpus(os.path.join(root, f"corpus_{label}"), n_utterances)
    c = load_config(os.path.join(here, "configs", config))
    c.update(data_path=os.path.join(corpus, "wavs"),
             output_path=os.path.join(root, f"runs_{label}"),
             steps_to_start_discriminator=VOC_DISC_START, epochs=1)
    c.update(overrides)
    cfg_path = os.path.join(root, f"{label}.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    trainer = train_main(["--config_path", cfg_path])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = trainer.global_step
    d_steps = sum(s["train_disc"] for s in trainer.step_stats)
    # 3 full-band resolutions x (y_hat, y) a generator step (no subbands);
    # the MelGAN discriminator's 9 kernel layers as in phase 8
    melgan_d = c["discriminator_model"] == "melgan_multiscale_discriminator"
    expect = {SK.KERNEL: 6 * steps,
              GCK.DGRAD: 27 * d_steps if melgan_d else 0,
              GCK.WGRAD: 18 * d_steps if melgan_d else 0}
    log({f"{label}_training_launches": launches, "steps": steps,
         "steps_with_discriminator": d_steps, "expected": expect})
    assert d_steps == max(0, steps - c["steps_to_start_discriminator"]) > 0
    for name, n in expect.items():
        assert launches.get(name, 0) == n, (name, launches, expect)
    for stats in trainer.step_stats:
        values = [v for k, v in stats.items() if k.startswith(("G_", "D_"))]
        assert values and all(np.isfinite(values)), stats
    assert "D_loss" in trainer.step_stats[-1]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(c.get("seed", 54321))
        init = {"G": setup_generator(c).state_dict(),
                "D": setup_discriminator(c).state_dict()}
    moved = {}
    for side, model in (("G", trainer.gen), ("D", trainer.disc)):
        diffs = [float((p.detach().cpu() - init[side][n]).abs().max())
                 for n, p in model.named_parameters()]
        moved[side] = f"{sum(d > 0 for d in diffs)}/{len(diffs)}"
        assert sum(d > 0 for d in diffs) > len(diffs) // 2, (side, moved)
    step_s = [s["step_time"] for s in trainer.step_stats]
    idle = gan_step_idle(trainer)
    log({f"{label}_training": config, "generator": c["generator_model"],
         "discriminator": c["discriminator_model"],
         "batch": c["batch_size"], "seq_len": c["seq_len"],
         "mixed_precision": c.get("mixed_precision", False),
         "steps": steps, "wall_s": wall_s,
         "ms_per_step_median_after_first": 1e3 * float(np.median(step_s[1:])),
         "ms_per_step": [1e3 * t for t in step_s],
         "loader_ms": [1e3 * s["loader_time"] for s in trainer.step_stats],
         "losses": [{k: v for k, v in s.items() if k.startswith(("G_", "D_"))}
                    for s in trainer.step_stats],
         "params_moved": moved, "peak_mem_gb": peak_gb,
         "step_with_discriminator": idle, "card": card})
    return trainer, cfg_path, launches


def pwgan_training_phase(dev, root: str, card: str) -> dict:
    """Phase 16: configs/parallel_wavegan.json, then 2 steps against the
    random window discriminators (tts_tpu's windows)."""
    trainer, cfg, _ = vocoder_training(dev, root, card,
                                       "parallel_wavegan.json",
                                       PWGAN_UTTERANCES, "pwgan")
    assert trainer.global_step == 6 and trainer.step.needs_noise
    # the batch at which gan_kernel_phase holds B5 against its plain version
    assert (trainer.c["batch_size"], trainer.c["seq_len"]) == (PWGAN_BATCH,
                                                               PWGAN_SEQ)
    rwd, _, _ = vocoder_training(
        dev, root, card, "parallel_wavegan.json", RWD_UTTERANCES, "pwgan_rwd",
        discriminator_model="random_window_discriminator",
        steps_to_start_discriminator=0)
    assert rwd.global_step == 2 and rwd.step.disc_takes_cond
    return {"trainer": trainer, "config": cfg}


def istft_training_phase(dev, root: str, card: str) -> dict:
    """Phase 17: configs/istft_melgan.json (bf16 mixed precision) against
    the multiscale MelGAN discriminator; first the first batch's generator
    losses and waveform in bfloat16 against float32 on the seeded
    weights."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.train.trainer_vocoder import (VocoderTrainer,
                                                     batch_to_device)

    here = os.path.dirname(os.path.abspath(__file__))
    c = load_config(os.path.join(here, "configs", "istft_melgan.json"))
    assert c["mixed_precision"]
    corpus = write_corpus(os.path.join(root, "corpus_probe"))
    c["data_path"] = os.path.join(corpus, "wavs")
    probe = VocoderTrainer(c, os.path.join(root, "probe"), device=dev)
    ds = probe.dataset
    batch = batch_to_device(ds.collate([ds[i] for i in
                                        range(c["batch_size"])]), dev)
    first, wav = {}, {}
    step = probe.step
    for dtype in (torch.float32, torch.bfloat16):
        step.dtype = dtype
        with torch.no_grad():
            first[str(dtype)] = {k: float(v) for k, v in
                                 step.generator_losses(batch, True).items()}
            wav[dtype] = step.gen_forward(
                {n: p.to(dtype) for n, p in probe.gen.named_parameters()},
                batch["mel"], batch["audio"].shape[-1])[0].float()
    f32, b16 = first["torch.float32"], first["torch.bfloat16"]
    rel = {k: abs(b16[k] - f32[k]) / abs(f32[k]) for k in f32}
    out_rel = float((wav[torch.bfloat16] - wav[torch.float32]).norm()
                    / wav[torch.float32].norm())
    log({"istft_first_batch_losses": first, "bf16_vs_fp32_rel": rel,
         "bf16_vs_fp32_waveform_rel_norm": out_rel,
         "batch": list(batch["audio"].shape)})
    assert all(rel[k] <= GAN_BF16_TOL for k in GAN_BF16_HELD), rel
    assert all(np.isfinite(v) for v in b16.values()), b16
    lo, hi = GAN_BF16_OUT_RANGE
    assert lo < out_rel < hi, out_rel
    del probe, batch, wav, step

    trainer, cfg, _ = vocoder_training(dev, root, card, "istft_melgan.json",
                                       N_UTTERANCES, "istft",
                                       epochs=ISTFT_EPOCHS)
    assert trainer.global_step == ISTFT_EPOCHS
    return {"trainer": trainer, "config": cfg}


# ---------------------------------------------------------------------------
# phase 18: serving ParallelWaveGAN and the iSTFT MelGAN
# ---------------------------------------------------------------------------

def vocoder_serving_phase(dev, root: str, card: str, trained: dict):
    """Phase 3's Glow-TTS in front of each trained generator: HTTP requests
    (B3 counted, no B1/B2), the CLI, the vocoder on the card against the
    CPU on the same mel, then the generator alone at phase 2's geometry."""
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import synthesis, text_to_seqvec
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.vocoder.pwgan import ParallelWaveganGenerator
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    paths = build_models(root)
    cfg = load_config(paths["tts_config"])
    texts = ["Hello world!",
             "The birch canoe slid on the smooth planks.",
             "Four hours of steady work faced us, and the source of the huge "
             "river was clear."]
    for label, run in trained.items():
        ckpt = latest_checkpoint(run["trainer"].output_path)
        synth = Synthesizer(paths["tts"], paths["tts_config"], ckpt,
                            run["config"], device=dev)
        assert synth._packed is None and synth._stacks is None
        hop = synth.vocoder_ap.hop_length
        build.reset_launches()
        requests = []
        for text, (wav, ms) in zip(texts, served_wavs(synth, texts)):
            frames = -(-6 * len(text_to_seqvec(text, cfg)) // 2) * 2
            expect = (frames * hop if frames % 32 else (frames + 4) * hop)
            assert len(wav) == expect + 10000, (len(wav), expect)
            assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
            requests.append({"text": text[:40], "latency_ms": ms,
                             "samples": len(wav)})
        launches = dict(build.LAUNCHES)
        want = encoder_launches(synth.model, texts)
        assert launches.get(GEK.KERNEL, 0) == want, (launches, want)
        for kernel in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
            assert launches.get(kernel, 0) == 0, (kernel, launches)
        log({f"{label}_serving": requests, "launches": launches,
             "first_request_ms": requests[0]["latency_ms"],
             "warm_request_ms": [r["latency_ms"] for r in requests[1:]]})

        # the vocoder on the card against the CPU on the same mel (phase
        # 3's first text; PWGAN's noise from the same CPU seed)
        mel = synthesis(synth.model, texts[0], cfg, dev,
                        generator=torch.Generator(dev).manual_seed(0)
                        )["postnet_outputs"]
        cpu = Synthesizer(paths["tts"], paths["tts_config"], ckpt,
                          run["config"], device="cpu")
        got, ref = synth._vocode(mel), cpu._vocode(mel)
        assert got.shape == ref.shape
        err = float(np.abs(got - ref).max())
        log({f"{label}_vocoder_vs_cpu_max_abs_err": err,
             "samples": len(got)})
        assert err < 1e-3, err

        # the synthesis CLI with this vocoder
        build.reset_launches()
        t0 = time.perf_counter()
        path = synthesize([texts[1], paths["tts_config"], paths["tts"],
                           os.path.join(root, f"cli_{label}"),
                           "--vocoder_path", ckpt,
                           "--vocoder_config_path", run["config"]])
        seconds = time.perf_counter() - t0
        cli_launches = dict(build.LAUNCHES)
        wav, _ = read_wav(path)
        frames = -(-6 * len(text_to_seqvec(texts[1], cfg)) // 2) * 2
        expect = frames * hop if frames % 32 else (frames + 4) * hop
        assert len(wav) == expect + 10000
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        assert cli_launches.get(GEK.KERNEL, 0) == encoder_launches(
            synth.model, texts[1:2])
        assert not any(cli_launches.get(k, 0) for k in
                       (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL))
        log({f"{label}_cli": os.path.basename(path), "samples": len(wav),
             "seconds_with_load": seconds, "launches": cli_launches})

        # the served (folded) generator alone at phase 2's geometry
        gen = synth.vocoder_model
        g = torch.Generator(dev).manual_seed(SEED)
        frames = MEL_FRAMES + 4
        mel = torch.randn(BATCH, 80, frames, generator=g, device=dev)
        if isinstance(gen, ParallelWaveganGenerator):
            z = torch.randn(BATCH, 1, frames * gen.hop, generator=g,
                            device=dev)
            inputs = (z, mel)
        else:
            inputs = (mel,)
        with torch.no_grad():
            ms = cuda_time_ms(lambda: gen(*inputs), 10)
            out = gen(*inputs)
        assert out.shape == (BATCH, 1, frames * gen.hop)
        assert bool(torch.isfinite(out).all())
        flops = conv_flops(gen, *inputs)
        weights = sum(p.numel() * 4 for p in gen.parameters())
        bound = bound_ms(nbytes(*inputs, out) + weights, flops)
        audio_s = out.numel() / synth.vocoder_ap.sample_rate
        log({f"{label}_generator": f"batch {BATCH}, {MEL_FRAMES} + 4 frames",
             "ms": ms, "audio_s_per_s": audio_s / (ms / 1e3),
             "fp32_gflop": flops / 1e9,
             "mflop_per_sample": flops / out.numel() / 1e6,
             "bound_ms": bound[0], "bound_by": bound[1], "card": card})
        del synth, cpu


# ---------------------------------------------------------------------------
# phases 19-21: the speaker encoder, multi-speaker training and serving
# ---------------------------------------------------------------------------

ENC_SPEAKERS, ENC_UTTERANCES = 64, 10   # configs/speaker_encoder.json's N, M
# utterances written per speaker: load_meta_data holds one item of the tree
# out even at eval_split_size 0 (tts_tpu's rule), and a speaker needs M left
VOX_UTTERANCES = ENC_UTTERANCES + 1
ENC_SAMPLE_RATE = 16000
ENC_STEPS = 4
ENC_CPU_SPEAKERS = 16       # speakers of the batch that the CPU check runs
VCTK_SPEAKERS, VCTK_UTTERANCES = 8, 12
MS_GLOW_EPOCHS = 2          # 95 training items at batch 32: 2 steps each
MS_TACO_EPOCHS = 3          # 95 training items at batch 64 (r 7): 1 each
MS_TACO_STEPS = 80          # served decoder budget (phase 10's)


def _voice(rng, n: int, sr: int, f0: float, timbre) -> np.ndarray:
    """A gliding harmonic tone of its speaker's pitch and harmonic weights,
    plus noise."""
    t = np.arange(n) / sr
    glide = f0 * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.3, 0.9) * t))
    phase = 2 * np.pi * np.cumsum(glide) / sr
    y = sum(w * np.sin((k + 1) * phase) for k, w in enumerate(timbre))
    return (0.3 * y / sum(timbre) + 0.02 * rng.standard_normal(n)
            ).astype(np.float32)


def write_voxceleb(root: str, n_speakers: int, n_utts: int) -> str:
    """voxceleb1 layout (<root>/wav/id1NNNN/<clip>/NNNNN.wav, 16 kHz): each
    speaker a pitch of 80-320 Hz and 5 harmonic weights of its own, each
    utterance 1.8-3.0 s."""
    from tts_tpu_torch.audio.processor import write_wav

    rng = np.random.default_rng(SEED + 19)
    for s in range(n_speakers):
        f0 = 80 * 4 ** (s / max(n_speakers - 1, 1))
        timbre = rng.uniform(0.1, 1.0, 5)
        for u in range(n_utts):
            n = int(rng.uniform(1.8, 3.0) * ENC_SAMPLE_RATE)
            path = os.path.join(root, "wav", f"id1{s:04d}", f"clip{u % 3}",
                                f"{u:05d}.wav")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_wav(path, _voice(rng, n, ENC_SAMPLE_RATE, f0, timbre),
                      ENC_SAMPLE_RATE)
    return root


def write_vctk(root: str, n_speakers: int, n_utts: int) -> str:
    """VCTK layout (txt/<spk>/<spk>_NNN.txt, wav48/<spk>/<spk>_NNN.wav at
    22,050 Hz): texts of 25-185 characters cut from SENTENCES, len / 15
    seconds of a voice of the speaker's own pitch and timbre."""
    from tts_tpu_torch.audio.processor import write_wav

    rng = np.random.default_rng(SEED + 20)
    words = " ".join(SENTENCES).split()
    for s in range(n_speakers):
        spk = f"p{225 + s}"
        f0 = 90 + 150 * s / max(n_speakers - 1, 1)
        timbre = rng.uniform(0.1, 1.0, 4)
        os.makedirs(os.path.join(root, "txt", spk), exist_ok=True)
        os.makedirs(os.path.join(root, "wav48", spk), exist_ok=True)
        for u, target in enumerate(np.linspace(25, 185, n_utts)):
            start, text = (5 * s + 7 * u) % len(words), ""
            while len(text) < target - 4:
                text = (text + " " + words[start % len(words)]).strip()
                start += 1
            dur = float(np.clip(len(text) / 15.0, 1.5, 10.0))
            name = f"{spk}_{u:03d}"
            with open(os.path.join(root, "txt", spk, name + ".txt"), "w",
                      encoding="utf-8") as f:
                f.write(text + "\n")
            write_wav(os.path.join(root, "wav48", spk, name + ".wav"),
                      _voice(rng, int(dur * SAMPLE_RATE), SAMPLE_RATE, f0,
                             timbre), SAMPLE_RATE)
    return root


def encoder_flops(n: int, frames: int, m: dict) -> float:
    """Forward FLOPs of the speaker encoder on n mels of ``frames``: per
    frame and layer the four gates' input and recurrent products,
    2 x 4H x (in + H), and the projection, 2 x H x P."""
    H, P = m["lstm_dim"], m["proj_dim"]
    per_frame = sum(2 * 4 * H * ((m["input_dim"] if i == 0 else P) + H)
                    + 2 * H * P for i in range(m["num_lstm_layers"]))
    return float(per_frame) * n * frames


def speaker_encoder_phase(dev, root: str, card: str) -> dict:
    """Phase 19: bin/train_encoder on configs/speaker_encoder.json as
    shipped, a step on the card against the CPU, then the d-vectors of the
    multi-speaker TTS corpus into speakers.json."""
    import copy

    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.bin.train_encoder import main as train_main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.data.formatters import vctk
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.train.trainer_encoder import train_step
    from tts_tpu_torch.utils.speakers import save_speaker_mapping

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    vox = write_voxceleb(os.path.join(root, "voxceleb1"), ENC_SPEAKERS,
                         VOX_UTTERANCES)
    corpus = write_vctk(os.path.join(root, "VCTK"), VCTK_SPEAKERS,
                        VCTK_UTTERANCES)
    write_s = time.perf_counter() - t0
    c = load_config(os.path.join(here, "configs", "speaker_encoder.json"))
    assert (c["num_speakers_in_batch"], c["num_utters_per_speaker"]) == (
        ENC_SPEAKERS, ENC_UTTERANCES)
    assert c["model"]["lstm_dim"] == 768 and c["model"]["num_lstm_layers"] == 3
    c["datasets"] = [{"name": "voxceleb1", "path": vox,
                      "meta_file_train": None}]
    c["print_step"] = 1
    cfg_path = os.path.join(root, "speaker_encoder.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)

    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    trainer = train_main(["--config_path", cfg_path, "--output_path",
                          os.path.join(root, "enc_runs"), "--num_steps",
                          str(ENC_STEPS)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = trainer.step_stats
    losses = [s["loss"] for s in stats]
    assert len(losses) == ENC_STEPS and np.isfinite(losses).all(), losses
    assert not any(build.LAUNCHES.values()), dict(build.LAUNCHES)
    N, M = ENC_SPEAKERS, ENC_UTTERANCES
    batch = trainer.dataset.storage[-1]["mels"]
    frames = batch.shape[1]
    fwd_flop = encoder_flops(N * M, frames, c["model"])
    mels = torch.from_numpy(batch).to(dev)
    prof = step_profile(lambda: train_step(trainer.module, trainer.optimizer,
                                           mels, N, M))

    # one step's loss on the card against the CPU, same weights and batch
    # (the first ENC_CPU_SPEAKERS speakers: GE2E over those)
    n = ENC_CPU_SPEAKERS
    sub = batch[:n * M]
    with torch.no_grad():
        on_card = trainer.module["criterion"](trainer.model(
            torch.from_numpy(sub).to(dev)).view(n, M, -1))
        cpu_module = copy.deepcopy(trainer.module).cpu()
        on_cpu = cpu_module["criterion"](cpu_module["model"](
            torch.from_numpy(sub)).view(n, M, -1))
    rel = abs(float(on_card) - float(on_cpu)) / abs(float(on_cpu))
    log({"speaker_encoder_training": "configs/speaker_encoder.json as "
                                     "shipped (GE2E softmax)",
         "batch": [N, M, frames, 40], "steps": len(stats),
         "corpus_write_s": write_s, "wall_s": wall_s,
         "ge2e_losses": losses,
         "ms_per_step": [1e3 * s["step_time"] for s in stats],
         "ms_median_after_first": 1e3 * float(np.median(
             [s["step_time"] for s in stats[1:]])),
         "loader_ms": [1e3 * s["loader_time"] for s in stats],
         "storage_replays": len(stats) - len(trainer.dataset.storage),
         "forward_tflop": fwd_flop / 1e12,
         "step_tflop_fwd_plus_2x_bwd": 3 * fwd_flop / 1e12,
         "profiled_step": prof, "peak_mem_gb": peak_gb,
         "loss_card_vs_cpu": {"speakers": n, "card": float(on_card),
                              "cpu": float(on_cpu), "rel": rel},
         "card": card})
    assert rel < 1e-4, rel

    # the d-vectors of every utterance of the TTS corpus (22,050 Hz,
    # resampled to the encoder's 16 kHz by load_wav) into speakers.json
    ap = AudioProcessor(**c["audio"])
    mapping, embs = {}, {}
    t0 = time.perf_counter()
    for _, wav, speaker in vctk(corpus):
        mel = ap.melspectrogram(ap.load_wav(wav))[None]
        emb = trainer.compute_embeddings(mel, num_frames=160, overlap=0.5)
        emb = emb[0].cpu().numpy()
        assert emb.shape == (256,) and np.isfinite(emb).all()
        assert abs(float(np.linalg.norm(emb)) - 1) < 1e-4
        mapping[wav] = {"name": speaker, "embedding": emb.tolist()}
        embs.setdefault(speaker, []).append(emb)
    embed_s = time.perf_counter() - t0
    save_speaker_mapping(root, mapping)
    means = np.stack([np.mean(v, 0) for v in embs.values()])
    within = float(np.mean([np.mean(np.stack(v) @ np.stack(v).T)
                            for v in embs.values()]))
    cross = float(np.mean((means @ means.T)[~np.eye(len(means), dtype=bool)]))
    log({"speakers_json": len(mapping), "speakers": len(embs),
         "embedding_s": embed_s, "cosine_within_speaker": within,
         "cosine_across_speaker_means": cross})
    return {"corpus": corpus, "speakers_json": os.path.join(
        root, "speakers.json"), "encoder": trainer}


def multispeaker_training_phase(dev, root: str, card: str,
                                encoded: dict) -> dict:
    """Phase 20: multi-speaker Glow-TTS (speaker ids), Tacotron2 reading
    phase 19's d-vectors, and Tacotron2 with d-vectors and GST, each at its
    shipped widths on the VCTK-style corpus through its training CLI."""
    from tts_tpu_torch.bin.train_glow_tts import main as train_glow
    from tts_tpu_torch.bin.train_tts import main as train_tts
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models import glow_tts as G
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.ops.cuda import mas as MAS
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK
    from tts_tpu_torch.train import trainer_glow, trainer_tts

    here = os.path.dirname(os.path.abspath(__file__))
    datasets = [{"name": "vctk", "path": encoded["corpus"]}]
    runs = {}

    c = load_config(os.path.join(here, "configs", "glow_tts_ljspeech.json"))
    c.update(datasets=datasets, use_speaker_embedding=True,
             phoneme_cache_path=os.path.join(root, "phoneme_cache"),
             epochs=MS_GLOW_EPOCHS)
    glow_cfg = os.path.join(root, "glow_multispeaker.json")
    with open(glow_cfg, "w") as f:
        json.dump(c, f)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    trainer = train_glow(["--config_path", glow_cfg, "--output_path",
                          os.path.join(root, "glow_runs")])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    steps = trainer.global_step
    assert trainer.num_speakers == VCTK_SPEAKERS, trainer.num_speakers
    assert steps >= 2 and launches.get(MAS.KERNEL, 0) == steps + 1, (
        launches, steps)          # one a step, one for the DDI pass
    assert launches.get(GEK.KERNEL, 0) == 0, launches
    losses = [s["loss"] for s in trainer.step_stats]
    assert np.isfinite(losses).all(), losses
    ds = trainer.dataset
    batch = trainer_glow.batch_to_device(ds.collate([ds[i] for i in range(
        len(ds) - c["batch_size"], len(ds))]), dev)
    assert batch["speaker_ids"].unique().numel() > 1
    model = trainer.model.train()
    prof = step_profile(lambda: trainer_glow.train_step(
        model, trainer.optimizer, batch))
    runs["glow"] = {"trainer": trainer, "config": glow_cfg}
    log({"multispeaker_training": "glow_tts, speaker ids "
                                  f"({trainer.num_speakers} speakers)",
         "steps": steps, "losses": losses, "wall_s": wall_s,
         "ms_per_step": [1e3 * s["step_time"] for s in trainer.step_stats],
         "loader_ms": [1e3 * s["loader_time"] for s in trainer.step_stats],
         "launches": launches, "profiled_longest_batch": prof,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "card": card})

    for label, gst in (("taco2_dvec", False), ("taco2_dvec_gst", True)):
        c = load_config(os.path.join(here, "configs",
                                     "tacotron2_ljspeech.json"))
        c.update(datasets=datasets, use_speaker_embedding=True,
                 use_external_speaker_embedding_file=True,
                 external_speaker_embedding_file=encoded["speakers_json"],
                 use_gst=gst,
                 phoneme_cache_path=os.path.join(root, "phoneme_cache"),
                 # the registry's defaults, which the config check wants
                 # spelled out with use_gst
                 gst={"gst_style_tokens": 10, "gst_embedding_dim": 512,
                      "gst_num_heads": 4},
                 epochs=MS_TACO_EPOCHS, max_decoder_steps=MS_TACO_STEPS)
        cfg_path = os.path.join(root, f"{label}.json")
        with open(cfg_path, "w") as f:
            json.dump(c, f)
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_tts(["--config_path", cfg_path, "--output_path",
                             os.path.join(root, f"{label}_runs")])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        m = trainer.model
        width = m.decoder.attention_rnn.input_size - 256
        assert width == 512 + 256 + (512 if gst else 0), width
        assert trainer.speaker_embedding_dim == 256
        assert launches.get(TDK.KERNEL, 0) == 0, launches
        # B7 runs only in the eval epochs' encoder (eval mode, no grad)
        assert launches.get(BLK.KERNEL, 0) > 0, launches
        stats = trainer.step_stats
        ds = trainer.dataset(is_eval=False, r=trainer.r)
        bs = c["gradual_training"][0][2]
        assert len(stats) == MS_TACO_EPOCHS * (len(ds) // bs) > 0, len(stats)
        assert all(np.isfinite(v) for s in stats for v in s.values()), stats
        batch = trainer_tts.batch_to_device(ds.collate([ds[i] for i in range(
            len(ds) - bs, len(ds))]), dev)
        split = taco2_step_split(trainer, batch, trainer.r)
        runs[label] = {"trainer": trainer, "config": cfg_path}
        log({"multispeaker_training": label, "decoder_in": width,
             "r": trainer.r, "batch": bs, "steps": len(stats),
             "losses": [s["loss"] for s in stats], "wall_s": wall_s,
             "ms_per_step": [1e3 * s["step_time"] for s in stats],
             "loader_ms": [1e3 * s["loader_time"] for s in stats],
             "fit_launches": launches, "profiled_longest_batch": split,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "card": card})
    return runs


def multispeaker_serving_phase(dev, root: str, card: str, encoded: dict,
                               runs: dict) -> dict:
    """Phase 21: the multi-speaker Glow checkpoint with Multiband-MelGAN
    through the HTTP server (?speaker_id=) and the CLI (--speaker_id); the
    d-vector and d-vector + GST Tacotron2 checkpoints through synthesis();
    each against the CPU on the same weights."""
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.bin.synthesize import main as synthesize
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import (bucket_text_length,
                                               compute_style_mel, synthesis,
                                               text_to_seqvec)
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train.checkpoint import latest_checkpoint
    from tts_tpu_torch.utils.speakers import load_speaker_mapping

    voc = build_models(root)
    glow = runs["glow"]["trainer"]
    c = load_config(runs["glow"]["config"])
    c["num_speakers"] = glow.num_speakers
    served_cfg = os.path.join(root, "glow_multispeaker_served.json")
    with open(served_cfg, "w") as f:
        json.dump(c, f)
    ckpt = latest_checkpoint(glow.output_path)
    synth = Synthesizer(ckpt, served_cfg, voc["voc"], voc["vocoder_config"],
                        device=dev)
    assert synth._packed is not None
    text = "The birch canoe slid on the smooth planks."
    speakers = (0, 1, 0, 1)
    build.reset_launches()
    answers = served_wavs(synth, [{"text": text, "speaker_id": s}
                                  for s in speakers])
    launches = dict(build.LAUNCHES)
    wavs, requests = {}, []
    for speaker, (wav, ms) in zip(speakers, answers):
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        if speaker in wavs:
            np.testing.assert_array_equal(wav, wavs[speaker])
        wavs[speaker] = wav
        requests.append({"speaker_id": speaker, "latency_ms": ms,
                         "samples": len(wav)})
    # ids out of range or not integers get 400 on the host, and the
    # process serves on (a lookup out of range on the card would be a
    # device-side assert, fatal to every later request)
    bad_ids = (str(glow.num_speakers), "-1", "x")
    answers = http_requests(synth, [{"text": text, "speaker_id": s}
                                    for s in bad_ids + (1,)])
    refused = {bad: status for bad, (status, _, _) in zip(bad_ids, answers)}
    assert all(code == 400 for code in refused.values()), refused
    assert answers[-1][0] == 200, answers[-1][0]
    np.testing.assert_array_equal(answers[-1][1], wavs[1])
    torch.cuda.synchronize()
    differ = (len(wavs[0]) != len(wavs[1])
              or float(np.abs(wavs[0] - wavs[1]).max()) > 1e-3)
    assert differ, "two speakers gave the same audio"
    for name in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
        assert launches.get(name, 0) > 0, f"{name} was not launched"
    assert launches.get(GEK.KERNEL, 0) == 0, launches   # B3 refuses speakers
    log({"multispeaker_glow_serving": requests, "launches": launches,
         "bad_speaker_id_status": refused,
         "first_request_ms": requests[0]["latency_ms"],
         "warm_request_ms": [r["latency_ms"] for r in requests[1:]],
         "card": card})

    # the CLI with --speaker_id, and the mel on the card against the CPU
    # (noise scale 0: the same noise on both)
    path = synthesize([text, served_cfg, ckpt, os.path.join(root, "cli_ms"),
                       "--vocoder_path", voc["voc"], "--vocoder_config_path",
                       voc["vocoder_config"], "--speaker_id", "1"])
    wav, _ = read_wav(path)
    assert len(wav) == len(wavs[1])
    np.testing.assert_allclose(wav, wavs[1], rtol=0, atol=2.0 / 32767)
    quiet = dict(c, inference_noise_scale=0.0)
    cpu = Synthesizer(ckpt, served_cfg, device="cpu")
    glow_err = {}
    for speaker in (0, 1):
        got = synthesis(synth.model, text, quiet, dev, speaker_id=speaker)
        ref = synthesis(cpu.model, text, quiet, torch.device("cpu"),
                        speaker_id=speaker)
        got, ref = got["postnet_outputs"], ref["postnet_outputs"]
        assert got.shape == ref.shape, (got.shape, ref.shape)
        err = float(np.abs(got - ref).max())
        assert err <= TOL * float(np.abs(ref).max()), (err, speaker)
        glow_err[speaker] = err
    log({"multispeaker_glow_cli": os.path.basename(path),
         "mel_card_vs_cpu_max_abs": glow_err})

    # where a warm request's time goes (B=1, without HTTP): the encoder
    # module (B3 refuses speakers), the whole text + Glow, the vocoder;
    # each ends in a copy to the host or a synchronize
    model, gen = synth.model, torch.Generator(dev)
    seq = torch.from_numpy(text_to_seqvec(text, c).astype(np.int64))[None]
    seq, lengths = seq.to(dev), torch.tensor([seq.shape[1]], device=dev)
    g = model.speaker_vector(torch.tensor([1], device=dev))
    for _ in range(3):
        t0 = time.perf_counter()
        with torch.no_grad():
            model.encode(seq, lengths, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mel = synthesis(model, text, c, dev, generator=gen.manual_seed(0),
                        speaker_id=1)["postnet_outputs"]
        t2 = time.perf_counter()
        synth._vocode(mel)
        t3 = time.perf_counter()
        log({"multispeaker_request_breakdown_ms": {
            "encoder_module": 1e3 * (t1 - t0),
            "text_and_glow": 1e3 * (t2 - t1), "vocoder": 1e3 * (t3 - t2)},
            "mel_frames": len(mel)})

    # Tacotron2 with d-vectors, and with d-vectors and GST, through
    # synthesis() (tts_tpu's Synthesizer serves neither: C20, C21)
    mapping = load_speaker_mapping(encoded["speakers_json"])
    wav_a, wav_b = sorted(mapping)[0], sorted(mapping)[-1]
    bucket = bucket_text_length(len(text_to_seqvec(text, load_config(
        runs["taco2_dvec"]["config"]))))
    out = {}
    for label in ("taco2_dvec", "taco2_dvec_gst"):
        tc = load_config(runs[label]["config"])
        trainer = runs[label]["trainer"]
        ckpt = latest_checkpoint(trainer.output_path)
        models = {}
        for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
            m = setup_model(num_symbols(tc["use_phonemes"]),
                            trainer.num_speakers, tc,
                            speaker_embedding_dim=256)
            m.load_state_dict(torch.load(ckpt, map_location="cpu",
                                         weights_only=True)["model"])
            m.set_r(trainer.r)
            models[key] = m.to(d).eval()
        kw = {"style_wav": wav_b} if tc["use_gst"] else {}
        results, ms = {}, []
        build.reset_launches()
        for wav_path in (wav_a, wav_b, wav_a):
            emb = np.asarray(mapping[wav_path]["embedding"], np.float32)
            t0 = time.perf_counter()
            res = synthesis(models["card"], text, tc, dev, ap=trainer.ap,
                            speaker_embedding=emb, **kw)
            ms.append(1e3 * (time.perf_counter() - t0))
            results.setdefault(wav_path, res["postnet_outputs"])
        launches = dict(build.LAUNCHES)
        assert launches.get(BLK.KERNEL, 0) == 3 * (1 + bucket), launches
        assert launches.get(TDK.KERNEL, 0) == 0, launches
        a, b = results[wav_a], results[wav_b]
        assert np.isfinite(a).all() and np.isfinite(b).all()
        speakers_differ = a.shape != b.shape or float(
            np.abs(a - b).max()) > 1e-4
        assert speakers_differ, label

        # card against CPU, same weights, d-vector and style, the stopnet
        # silenced (threshold 2: no step is masked): per decoder step, the
        # first step whose frames differ by more than 1e-4 of the largest
        # magnitude (the decode is autoregressive)
        emb = np.asarray(mapping[wav_a]["embedding"], np.float32)
        seq = torch.from_numpy(text_to_seqvec(text, tc).astype(np.int64)
                               )[None].to(dev)
        cond = {"speaker_embeddings": torch.from_numpy(emb)[None]}
        if tc["use_gst"]:
            cond["style_mel"] = torch.from_numpy(
                compute_style_mel(wav_b, trainer.ap))
        apart = decode_apart(models["card"], models["cpu"], seq,
                             MS_TACO_STEPS, **cond)
        frames_served = [len(x) for x in results.values()]
        log({f"{label}_serving": {"first_ms": ms[0], "warm_ms": ms[1:],
                                  "launches": launches,
                                  "text_bucket": bucket,
                                  "frames": frames_served},
             **{f"card_vs_cpu_{k}": v for k, v in apart.items()},
             "card": card})
        first = apart["first_step_apart_by_1e-4"]
        assert first is None or first >= 16, first
        out[label] = launches
    return out


# ---------------------------------------------------------------------------
# phases 22-25: Tacotron v1, Graves attention, streaming, Glow's gated-conv
# and separable encoders
# ---------------------------------------------------------------------------

V1_EPOCHS = 3              # 95 training items at batch 64 (r 7): 1 step each
V1_STEPS = 80              # served decoder budget (phase 10's)
V1_BAD_SENTENCE = "This test sentence is made to fail."
STREAM_CHARS = 48          # tts_tpu's chunk size and step budget a chunk
STREAM_STEPS = 128
STREAM_TEXT = ("The birch canoe slid on the smooth planks, and the source of "
               "the huge river was the clear spring that ran beside the "
               "parked truck all through the evening.")
GLOW_ENC_EPOCHS = 2        # 95 training items at batch 32: 2 steps each


def http_requests(synth, queries) -> list:
    """``queries`` (each a text, or a dict of query parameters) through one
    HTTP server over ``synth`` in a thread: per request (status, WAV,
    latency ms); a 200 must carry a RIFF body, another status has no WAV."""
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.server.server import create_server

    server = create_server(synth, port=0, host="127.0.0.1")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = []
    try:
        for query in queries:
            if isinstance(query, str):
                query = {"text": query}
            url = (f"http://127.0.0.1:{port}/api/tts?"
                   + urllib.parse.urlencode(query))
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(url, timeout=300) as r:
                    status, body = r.status, r.read()
            except urllib.error.HTTPError as e:
                status, body = e.code, b""
            ms = 1e3 * (time.perf_counter() - t0)
            wav = None
            if status == 200:
                assert body[:4] == b"RIFF", body[:16]
                wav = read_wav(body)[0]
            out.append((status, wav, ms))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return out


def served_wavs(synth, queries) -> list:
    """``http_requests`` whose every answer is a 200: (WAV, ms) each."""
    out = http_requests(synth, queries)
    assert all(status == 200 for status, _, _ in out), [o[0] for o in out]
    return [(wav, ms) for _, wav, ms in out]


def decode_apart(model, cpu_model, seq, steps: int, **kw) -> dict:
    """``model.inference`` on the card against ``cpu_model``'s on the
    same weights and text, every stop masked off (threshold 2): per
    decoder step the largest frame difference; the first step apart by
    more than 1e-4 of the largest magnitude (None if none). Tensors in
    ``kw`` go to each model's device."""
    frames = []
    for m, d in ((model, seq.device), (cpu_model, torch.device("cpu"))):
        m.stop_threshold = 2.0
        out = m.inference(seq.to(d), max_decoder_steps=steps,
                          **{k: v.to(d) for k, v in kw.items()})
        frames.append(out["decoder_outputs"][0].reshape(steps, -1).cpu())
    scale = float(frames[1].abs().max())
    per_step = (frames[0] - frames[1]).abs().amax(1).numpy()
    bad = np.nonzero(per_step > TOL * scale)[0]
    return {"first_step_apart_by_1e-4": int(bad[0]) if len(bad) else None,
            "max_abs_16_steps": float(per_step[:16].max()),
            "max_abs_all_steps": float(per_step.max()), "scale": scale}


def tacotron_v1_phase(dev, root: str, card: str) -> dict:
    """Phase 22: Tacotron v1 trained through bin/train_tts and served with
    Griffin-Lim through HTTP and the CLI."""
    from tts_tpu_torch.bin.synthesize import main as synthesize
    from tts_tpu_torch.bin.train_tts import main as train_tts
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import text_to_seqvec
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.layers import BatchNorm1d
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.models.tacotron import Tacotron
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train import trainer_tts
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    corpus = os.path.join(root, "LJSpeech")
    if not os.path.isdir(corpus):
        write_corpus(corpus)
    c = load_config(os.path.join(here, "configs", "tacotron2_ljspeech.json"))
    overrides = {"model": "tacotron", "attention_norm": "sigmoid",
                 "memory_size": 5}
    c.update(overrides, epochs=V1_EPOCHS, test_delay_epochs=V1_EPOCHS - 1,
             max_decoder_steps=V1_STEPS,
             test_sentences=[SENTENCES[0], V1_BAD_SENTENCE, SENTENCES[1]],
             phoneme_cache_path=os.path.join(root, "phoneme_cache"))
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    cfg_path = os.path.join(root, "tacotron.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    log({"tacotron_v1_config": "configs/tacotron2_ljspeech.json",
         "overrides": overrides, "r": c["r"],
         "gradual_training": c["gradual_training"],
         "mixed_precision": c["mixed_precision"],
         "linear_bins": c["audio"]["fft_size"] // 2 + 1})

    # one test sentence made to fail (C24): it is reported, the others run
    real_synthesis = trainer_tts.synthesis

    def synthesis(model, sentence, *args, **kwargs):
        if sentence == V1_BAD_SENTENCE:
            raise RuntimeError("made to fail")
        return real_synthesis(model, sentence, *args, **kwargs)

    trainer_tts.synthesis = synthesis
    try:
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_tts(["--config_path", cfg_path, "--output_path",
                             os.path.join(root, "tacotron_runs")])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        fit_launches = dict(build.LAUNCHES)
        audios = trainer.test_run()
    finally:
        trainer_tts.synthesis = real_synthesis
    assert isinstance(trainer.model, Tacotron)
    assert sorted(audios) == ["test_0", "test_2"], sorted(audios)
    assert all(np.isfinite(a).all() and np.abs(a).max() > 0
               for a in audios.values())
    assert fit_launches.get(BLK.KERNEL, 0) == 0, fit_launches
    assert fit_launches.get(TDK.KERNEL, 0) == 0, fit_launches
    stats = trainer.step_stats
    assert len(stats) == V1_EPOCHS, len(stats)
    assert all(np.isfinite(v) for s in stats for v in s.values()), stats
    assert trainer.loss_kwargs["use_linear"] and trainer.dtype == torch.bfloat16
    bs = c["gradual_training"][0][2]
    ds = trainer.dataset(is_eval=False, r=trainer.r)
    batch = trainer_tts.batch_to_device(ds.collate([ds[i] for i in range(
        len(ds) - bs, len(ds))]), dev)
    with torch.no_grad():
        out = trainer_tts.forward(trainer.model.eval(), batch)
    assert batch["linear"].shape[-1] == c["audio"]["fft_size"] // 2 + 1
    assert out["postnet_outputs"].shape == batch["linear"].shape
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(c.get("seed", 54321))
        init = setup_model(num_symbols(c["use_phonemes"]), 1, c).state_dict()
    still = [n for n, p in trainer.model.named_parameters()
             if torch.equal(p.detach().cpu(), init[n])]
    bn_still = [n for n, m in trainer.model.named_modules()
                if isinstance(m, BatchNorm1d)
                and torch.equal(m.running_var.cpu(),
                                init[f"{n}.running_var"])]
    assert not bn_still, bn_still
    split = taco2_step_split(trainer, batch, trainer.r)
    ckpt = latest_checkpoint(trainer.output_path)
    log({"tacotron_v1_training": "bin/train_tts", "r": trainer.r,
         "batch": bs, "steps": len(stats), "wall_s": wall_s,
         "losses": [{k: s[k] for k in ("decoder_loss", "postnet_loss",
                                       "stopnet_loss", "loss")}
                    for s in stats],
         "ms_per_step": [1e3 * s["step_time"] for s in stats],
         "loader_ms": [1e3 * s["loader_time"] for s in stats],
         "params_unmoved": still, "fit_launches": fit_launches,
         "test_sentences_served": sorted(audios),
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
         "profiled_longest_batch": split, "card": card})

    # the checkpoint with Griffin-Lim through HTTP and the CLI
    synth = Synthesizer(ckpt, cfg_path, device=dev)
    assert synth.model.r == trainer.r
    texts = ["Hello world!", SENTENCES[2]]
    build.reset_launches()
    served = served_wavs(synth, texts + texts[:1])
    t0 = time.perf_counter()
    path = synthesize([SENTENCES[3], cfg_path, ckpt,
                       os.path.join(root, "cli_tacotron")])
    cli_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    assert launches.get(BLK.KERNEL, 0) == 0, launches
    assert launches.get(TDK.KERNEL, 0) == 0, launches
    cli_wav, _ = read_wav(path)
    for wav in [w for w, _ in served] + [cli_wav]:
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    np.testing.assert_array_equal(served[0][0], served[2][0])

    # the decode on the card against the CPU on the same weights
    cpu = Synthesizer(ckpt, cfg_path, device="cpu").model
    seq = torch.from_numpy(text_to_seqvec(texts[1], c).astype(np.int64)
                           )[None].to(dev)
    apart = decode_apart(synth.model, cpu, seq, V1_STEPS)
    # a mel vocoder cannot read the linear bins (C26)
    voc = build_models(root)
    try:
        Synthesizer(ckpt, cfg_path, voc["voc"], voc["vocoder_config"],
                    device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    log({"tacotron_v1_serving": [{"text": t[:40], "latency_ms": ms,
                                  "samples": len(w)}
                                 for t, (w, ms) in zip(texts + texts[:1],
                                                       served)],
         "cli_s_with_load": cli_s, "cli_samples": len(cli_wav),
         "launches": launches, "card_vs_cpu": apart,
         "mel_vocoder_refused": refused,
         "phase_s": time.perf_counter() - t_phase, "card": card})
    assert refused and "linear spectrogram" in refused
    a = apart["first_step_apart_by_1e-4"]
    assert a is None or a >= 16, apart
    return {"synth": synth, "config": cfg_path}


def graves_phase(dev, root: str, card: str) -> None:
    """Phase 23: a Tacotron2 at tacotron2_ljspeech.json's widths with
    Graves attention (5 components): one training step, then served
    through synthesis()."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.fast_decode import supports_fused_decode
    from tts_tpu_torch.infer.synthesis import (bucket_text_length, synthesis,
                                               text_to_seqvec)
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.ops.attention import GravesAttention
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train import trainer_tts

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    corpus = os.path.join(root, "LJSpeech")
    if not os.path.isdir(corpus):
        write_corpus(corpus)
    c = load_config(os.path.join(here, "configs", "tacotron2_ljspeech.json"))
    c.update(attention_type="graves", attention_heads=5,
             max_decoder_steps=TACO_SERVED_STEPS,
             phoneme_cache_path=os.path.join(root, "phoneme_cache"))
    c["datasets"] = [{"name": "ljspeech", "path": corpus,
                      "meta_file_train": "metadata.csv"}]
    trainer = trainer_tts.TTSTrainer(c, os.path.join(root, "graves_runs"),
                                     device=dev)
    model = trainer.model
    assert isinstance(model.decoder.attention, GravesAttention)
    assert not supports_fused_decode(model)
    r, bs = c["gradual_training"][0][1:3]
    model.set_r(r)
    ds = trainer.dataset(is_eval=False, r=r)
    batch = trainer_tts.batch_to_device(ds.collate([ds[i] for i in range(
        len(ds) - bs, len(ds))]), dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    losses = trainer_tts.train_step(model.train(), trainer.optimizer, batch,
                                    dict(trainer.loss_kwargs, r=r),
                                    trainer.dtype)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    assert all(np.isfinite(v) for v in losses.values()), losses
    moved = [n for n, p in model.named_parameters() if p.requires_grad
             and not torch.equal(p.detach(), before[n])]
    graves_moved = [n for n in moved if ".attention.N_a." in n]
    assert graves_moved, "Graves's weights did not move"

    model.eval().set_r(r)
    text = SENTENCES[4]
    bucket = bucket_text_length(len(text_to_seqvec(text, c)))
    ms = []
    build.reset_launches()
    for _ in range(3):
        t0 = time.perf_counter()
        res = synthesis(model, text, c, dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(build.LAUNCHES)
    assert launches.get(BLK.KERNEL, 0) == 3 * (1 + bucket), launches
    assert launches.get(TDK.KERNEL, 0) == 0, launches
    assert np.isfinite(res["postnet_outputs"]).all()
    cpu = setup_model(num_symbols(c["use_phonemes"]), 1, c)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu.eval().set_r(r)
    seq = torch.from_numpy(text_to_seqvec(text, c).astype(np.int64)
                           )[None].to(dev)
    apart = decode_apart(model, cpu, seq, TACO_SERVED_STEPS)
    log({"graves_training_step": {"losses": losses, "step_ms": step_ms,
                                  "batch": list(batch["mel"].shape),
                                  "moved": len(moved),
                                  "graves_moved": graves_moved},
         "graves_serving": {"first_ms": ms[0], "warm_ms": ms[1:],
                            "text_bucket": bucket, "launches": launches},
         "card_vs_cpu": apart, "phase_s": time.perf_counter() - t_phase,
         "card": card})
    a = apart["first_step_apart_by_1e-4"]
    assert a is None or a >= 16, apart


def streaming_phase(dev, root: str, card: str, v1: dict) -> None:
    """Phase 24: phase 10's Tacotron2 with phase 3's Multiband-MelGAN
    streamed through Synthesizer.tts_stream, 48-character chunks of 128
    steps; a Tacotron v1 model is refused (C25)."""
    from tts_tpu_torch.infer.streaming import chunk_words, stream_mel_chunks
    from tts_tpu_torch.infer.synthesis import (bucket_text_length,
                                               text_to_seqvec)
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK

    t_phase = time.perf_counter()
    voc = build_models(root)
    paths, cfg = build_taco2(root)
    synth = Synthesizer(paths["taco2"], paths["taco2_config"], voc["voc"],
                        voc["vocoder_config"], device=dev)
    chunks = chunk_words(STREAM_TEXT, STREAM_CHARS)
    assert len(chunks) >= 3 and max(map(len, chunks)) <= STREAM_CHARS
    buckets = [bucket_text_length(len(text_to_seqvec(t, cfg)))
               for t in chunks]
    runs = []
    for _ in range(2):              # the first run warms, the second is kept
        build.reset_launches()
        t0 = time.perf_counter()
        marks, pieces = [], []
        for wav in synth.tts_stream(STREAM_TEXT, chunk_chars=STREAM_CHARS,
                                    decoder_steps=STREAM_STEPS):
            marks.append(1e3 * (time.perf_counter() - t0))
            pieces.append(wav)
        runs.append((marks, pieces, dict(build.LAUNCHES)))
    marks, pieces, launches = runs[-1]
    assert len(pieces) == len(chunks) + 1, len(pieces)   # + the gap
    assert launches.get(BLK.KERNEL, 0) == sum(1 + b for b in buckets), (
        launches, buckets)
    assert launches.get(TDK.KERNEL, 0) == 0, launches
    for name in (M.PROJ_IN, M.TAIL):
        assert launches.get(name, 0) == len(chunks), (name, launches)
    for name in (M.UPSAMPLE, R.KERNEL):
        assert launches.get(name, 0) > 0, (name, launches)
    for wav in pieces[:-1]:
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    tts_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        whole = synth.tts(STREAM_TEXT)
        tts_ms.append(1e3 * (time.perf_counter() - t0))
    # the first chunk's mel on the card against the CPU
    cpu = Synthesizer(paths["taco2"], paths["taco2_config"],
                      device="cpu").model
    firsts = [next(stream_mel_chunks(m, STREAM_TEXT, cfg, d,
                                     chunk_chars=STREAM_CHARS,
                                     decoder_steps=STREAM_STEPS))["mel"]
              for m, d in ((synth.model, dev), (cpu, torch.device("cpu")))]
    assert firsts[0].shape == firsts[1].shape
    err = float(np.abs(firsts[0] - firsts[1]).max())
    scale = float(np.abs(firsts[1]).max())
    # Tacotron v1 has no inference_truncated, in tts_tpu neither (C25)
    try:
        next(v1["synth"].tts_stream("Hello world.", decoder_steps=4))
        v1_refused = None
    except AttributeError as e:
        v1_refused = str(e)
    log({"streaming": {"chunks": chunks, "text_buckets": buckets,
                       "ms_to_each_chunk": marks,
                       "first_chunk_ms": marks[0], "stream_ms": marks[-1],
                       "first_run_first_chunk_ms": runs[0][0][0],
                       "tts_same_text_ms": tts_ms,
                       "tts_samples": len(whole),
                       "chunk_samples": [len(p) for p in pieces],
                       "launches": launches},
         "first_chunk_card_vs_cpu_max_abs": err, "scale": scale,
         "tacotron_v1_refused": v1_refused,
         "phase_s": time.perf_counter() - t_phase, "card": card})
    assert err <= TOL * scale, (err, scale)
    assert v1_refused and "inference_truncated" in v1_refused


def glow_encoders_phase(dev, root: str, card: str) -> None:
    """Phase 25: configs/glow_tts_ljspeech.json with the gated-conv and the
    time-depth-separable encoder, trained through bin/train_glow_tts and
    served over HTTP with phase 3's vocoder."""
    from tts_tpu_torch.bin.train_glow_tts import main as train_glow
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import text_to_seqvec
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.layers import BatchNorm1d
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.ops.cuda import mas as MAS
    from tts_tpu_torch.ops.glow_encoder import supports_fused_encoder
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train import trainer_glow
    from tts_tpu_torch.train.checkpoint import latest_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    corpus = os.path.join(root, "LJSpeech")
    if not os.path.isdir(corpus):
        write_corpus(corpus)
    voc = build_models(root)
    for encoder_type in ("gatedconv", "time-depth-separable"):
        t_phase = time.perf_counter()
        c = load_config(os.path.join(here, "configs",
                                     "glow_tts_ljspeech.json"))
        c.update(encoder_type=encoder_type, epochs=GLOW_ENC_EPOCHS,
                 phoneme_cache_path=os.path.join(root, "phoneme_cache"))
        c["datasets"] = [{"name": "ljspeech", "path": corpus,
                          "meta_file_train": "metadata.csv"}]
        cfg_path = os.path.join(root, f"glow_{encoder_type}.json")
        with open(cfg_path, "w") as f:
            json.dump(c, f)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(c.get("seed", 54321))
            init = setup_model(num_symbols(c["use_phonemes"]), 1,
                               c).state_dict()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        trainer = train_glow(["--config_path", cfg_path, "--output_path",
                              os.path.join(root, f"glow_{encoder_type}")])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        fit = dict(build.LAUNCHES)
        steps = trainer.global_step
        assert steps == 4, steps
        assert fit.get(MAS.KERNEL, 0) == steps + 1, fit   # + the DDI pass
        assert fit.get(GEK.KERNEL, 0) == 0, fit
        assert not supports_fused_encoder(trainer.model.encoder)
        stats = trainer.step_stats
        assert all(np.isfinite(v) for s in stats for v in s.values()), stats
        norms = [n for n, m in trainer.model.named_modules()
                 if isinstance(m, BatchNorm1d)]
        assert bool(norms) == (encoder_type == "time-depth-separable")
        bn_still = [n for n in norms if torch.equal(
            trainer.model.get_submodule(n).running_var.cpu(),
            init[f"{n}.running_var"])]
        assert not bn_still, bn_still
        ds = trainer.dataset
        batch = trainer_glow.batch_to_device(ds.collate([ds[i] for i in range(
            len(ds) - c["batch_size"], len(ds))]), dev)
        prof = step_profile(lambda: trainer_glow.train_step(
            trainer.model.train(), trainer.optimizer, batch))
        ckpt = latest_checkpoint(trainer.output_path)
        saved = torch.load(ckpt, map_location="cpu", weights_only=True)
        for n in norms:
            assert f"{n}.running_var" in saved["model"], n
        log({"glow_encoder_training": encoder_type, "steps": steps,
             "losses": [s["loss"] for s in stats], "wall_s": wall_s,
             "ms_per_step": [1e3 * s["step_time"] for s in stats],
             "loader_ms": [1e3 * s["loader_time"] for s in stats],
             "launches": fit, "batchnorms_moved": len(norms),
             "profiled_longest_batch": prof,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "card": card})

        synth = Synthesizer(ckpt, cfg_path, voc["voc"], voc["vocoder_config"],
                            device=dev)
        assert synth._packed is not None
        texts = ["Hello world!", SENTENCES[5], "Hello world!"]
        build.reset_launches()
        served = served_wavs(synth, texts)
        launches = dict(build.LAUNCHES)
        assert launches.get(GEK.KERNEL, 0) == 0, launches
        for name in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
            assert launches.get(name, 0) > 0, (name, launches)
        for wav, _ in served:
            assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        np.testing.assert_array_equal(served[0][0], served[2][0])
        cpu = Synthesizer(ckpt, cfg_path, device="cpu").model
        seq = torch.from_numpy(text_to_seqvec(SENTENCES[5], c).astype(
            np.int64))[None]
        outs = [m.inference(seq.to(d), noise_scale=0.0)
                for m, d in ((synth.model, dev), (cpu, torch.device("cpu")))]
        assert torch.equal(outs[0]["mel_lengths"].cpu(),
                           outs[1]["mel_lengths"])
        mel = [o["model_outputs"].cpu() for o in outs]
        err = float((mel[0] - mel[1]).abs().max())
        scale = float(mel[1].abs().max())
        log({"glow_encoder_serving": encoder_type,
             "requests": [{"text": t[:40], "latency_ms": ms,
                           "samples": len(w)}
                          for t, (w, ms) in zip(texts, served)],
             "launches": launches, "mel_card_vs_cpu_max_abs": err,
             "scale": scale, "phase_s": time.perf_counter() - t_phase,
             "card": card})
        assert err <= TOL * scale, (err, scale)


# ---------------------------------------------------------------------------
# phases 26-29: WaveRNN behind Glow-TTS, eval_model, statistics and the
# converter, torch.export
# ---------------------------------------------------------------------------

# 18, 30 and 42 mel frames: buckets of 32, 32 and 64 frames
WAVERNN_TEXTS = ["Hi.", "Yes.", "Hello."]
WAVERNN_PROFILED_FRAMES = 4     # 1,024 samples
EVAL_UTTERANCES = 16        # all held out: two batches of 8


def build_wavernn(root: str, mode=10, factors=(4, 8, 8),
                  name: str = "wavernn") -> dict:
    """configs/multiband_melgan.json's audio with generator_model "wavernn"
    at fatchord's full width (rnn and fc 512, compute and res-out 128, 10
    res blocks, pad 2, upsample ``factors``; ``mode`` 10 bits or "mold"
    with 10 mixtures), seeded, with the GRUs' r and z hidden-side biases at
    zero (one bias per gate, as weights carried from tts_tpu have) and
    seeded BatchNorm statistics: {"config", "checkpoint"} paths."""
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.models.vocoder.registry import setup_generator

    here = os.path.dirname(os.path.abspath(__file__))
    c = load_config(os.path.join(here, "configs", "multiband_melgan.json"))
    c.update(generator_model="wavernn", mode=mode,
             generator_model_params={"upsample_factors": list(factors)})
    torch.manual_seed(SEED)
    gen = setup_generator(c)
    sd = gen.state_dict()
    for key, value in sd.items():
        if key.endswith("running_var"):
            value.uniform_(0.5, 1.5)
        elif key.endswith("running_mean"):
            value.normal_(0.0, 0.1)
        elif key.startswith("rnn") and "bias_hh" in key:
            value[:2 * gen.rnn_dims] = 0
    paths = {"config": os.path.join(root, f"{name}.json"),
             "checkpoint": os.path.join(root, f"{name}.pt")}
    with open(paths["config"], "w") as f:
        json.dump(c, f)
    torch.save({"model": sd}, paths["checkpoint"])
    return paths


def wavernn_bytes_per_sample(gen) -> int:
    """What one step of ``WaveRNN.sample_loop`` reads (float32): I's
    previous-sample column, both GRUs, fc1's and fc2's hidden-side columns,
    fc3, and the step's rows of the projected conditioning (I, fc1, fc2)
    and of the second aux group."""
    R, F = gen.rnn_dims, gen.fc1.out_features
    n = (R + sum(p.numel() for p in gen.rnn1.parameters())
         + sum(p.numel() for p in gen.rnn2.parameters())
         + F * R + F * F + gen.fc3.weight.numel() + gen.fc3.bias.numel()
         + R + 2 * F + gen.aux_dims)
    return 4 * n


def vocoder_mel(synth, mel_norm: np.ndarray) -> torch.Tensor:
    """The mel ``Synthesizer._vocode`` hands a WaveRNN: bucketed to 32
    frames and edge-padded by its context frames, (1, M, T) on its
    device."""
    gen = synth.vocoder_model
    n = mel_norm.shape[0]
    nb = max(32, -(-n // 32) * 32)
    mel = np.pad(mel_norm, ((gen.pad, nb - n + gen.pad), (0, 0)),
                 mode="edge")
    return torch.from_numpy(np.ascontiguousarray(mel.T, np.float32))[None] \
        .to(synth.device)


def wavernn_phase(dev, root: str, card: str) -> dict:
    """Phase 26: Glow-TTS -> WaveRNN served over HTTP and the CLI. Returns
    phase 3's model paths (``paths``), the WaveRNN's (``voc``), and the
    first request's audio from its profiled sample loop (``reference``)."""
    from tts_tpu_torch.bin.synthesize import main as synthesize
    from tts_tpu_torch.audio.processor import read_wav
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.infer.synthesis import synthesis, text_to_seqvec
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.models.vocoder import wavernn as W
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK

    t_phase = time.perf_counter()
    stages, clock = {}, [t_phase]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stages[name] = now - clock[0]
        clock[0] = now

    paths = build_models(root)
    voc = build_wavernn(root)
    synth = Synthesizer(paths["tts"], paths["tts_config"], voc["checkpoint"],
                        voc["config"], device=dev)
    gen = synth.vocoder_model
    assert isinstance(gen, W.WaveRNN) and synth._packed is None
    cfg = load_config(paths["tts_config"])
    hop = synth.vocoder_ap.hop_length
    assert gen.hop == hop == 256
    frames = [-(-6 * len(text_to_seqvec(t, cfg)) // 2) * 2
              for t in WAVERNN_TEXTS]
    buckets = [max(32, -(-n // 32) * 32) for n in frames]
    assert max(buckets) > 32, buckets
    stage("models_s")

    # three requests over HTTP; the vocoder's share of each timed inside
    # the server
    vocode_ms = []

    def timed_vocode(mel_norm, vocode=synth._vocode):
        t0 = time.perf_counter()
        wav = vocode(mel_norm)
        vocode_ms.append((time.perf_counter() - t0) * 1e3)
        return wav

    synth._vocode = timed_vocode
    build.reset_launches()
    served = served_wavs(synth, WAVERNN_TEXTS)
    launches = dict(build.LAUNCHES)
    del synth._vocode
    assert launches.get(GEK.KERNEL, 0) == encoder_launches(
        synth.model, WAVERNN_TEXTS), launches
    for name in (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL):
        assert launches.get(name, 0) == 0, (name, launches)
    stage("http_s")
    # Glow's share: the same mels again (tens of ms each)
    requests, mels = [], []
    for text, n, nb, (wav, ms), voc_ms in zip(WAVERNN_TEXTS, frames, buckets,
                                              served, vocode_ms):
        assert len(wav) == n * hop + 10000, (len(wav), n * hop)
        assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
        t0 = time.perf_counter()
        mel = synthesis(synth.model, text, cfg, dev,
                        generator=torch.Generator(dev).manual_seed(0))
        mels.append(mel["postnet_outputs"])
        assert mels[-1].shape[0] == n, (mels[-1].shape, n)
        requests.append({
            "text": text, "mel_frames": n, "bucket_frames": nb,
            "samples_generated": nb * hop, "samples_served": len(wav),
            "latency_ms": ms, "wavernn_ms": voc_ms,
            "glow_ms": (time.perf_counter() - t0) * 1e3,
            "us_per_sample": voc_ms * 1e3 / (nb * hop),
            "rtf": ms / 1e3 / (n * hop / synth.ap.sample_rate)})
    stage("glow_s")

    # the CLI, one request
    build.reset_launches()
    path = synthesize([WAVERNN_TEXTS[0], paths["tts_config"], paths["tts"],
                       os.path.join(root, "cli_wavernn"), "--vocoder_path",
                       voc["checkpoint"], "--vocoder_config_path",
                       voc["config"]])
    cli_launches = dict(build.LAUNCHES)
    wav, _ = read_wav(path)
    assert len(wav) == frames[0] * hop + 10000
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    assert cli_launches.get(GEK.KERNEL, 0) == encoder_launches(
        synth.model, WAVERNN_TEXTS[:1]), cli_launches
    # the same request as the server's, through 16-bit WAV
    assert np.abs(wav - served[0][0]).max() <= 1.0 / 32767, "CLI vs HTTP"
    stage("cli_s")

    # tts_tpu's hop check: upsampling of 128 under a hop of 256
    bad = build_wavernn(root, factors=(4, 8, 4), name="wavernn_hop128")
    try:
        Synthesizer(paths["tts"], paths["tts_config"], bad["checkpoint"],
                    bad["config"], device=dev)
        raise AssertionError("a WaveRNN of hop 128 served under hop 256")
    except ValueError as e:
        assert "hop_length" in str(e), e
    stage("hop_check_s")

    # the first request's sample loop again, on the served mel with the
    # served draws: it gives the served audio
    mel_p = vocoder_mel(synth, mels[0])
    T = (mel_p.shape[-1] - 2 * gen.pad) * hop
    u = gen.draws(1, T, torch.Generator().manual_seed(0), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = gen.sample_loop(mel_p, u)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    reference = gen.waveform(samples)[0].cpu().numpy()[:frames[0] * hop]
    # in 16-bit codes: the WAV holds int(y * 32767), read back over 32768
    served_codes = np.round(served[0][0][:len(reference)] * 32768.0)
    served_err = int(np.abs(served_codes - (reference * 32767.0)
                            .astype("<i2")).max())
    assert served_err <= 1, ("served vs loop, codes apart", served_err)
    stage("loop_s")
    # its first frames profiled: tracing costs the host ~7 ms a sample
    n_prof = WAVERNN_PROFILED_FRAMES * hop
    prof = busy_summary(kernel_profile(lambda: gen.sample_loop(
        mel_p[..., :WAVERNN_PROFILED_FRAMES + 2 * gen.pad], u[..., :n_prof])),
        loop_ms * n_prof / T, top=8)
    weight_bytes = wavernn_bytes_per_sample(gen)
    loop = {"samples": T, "wall_ms": loop_ms,
            "us_per_sample": loop_ms * 1e3 / T, "profiled_samples": n_prof,
            "kernels_per_sample": prof["kernels_launched"] / n_prof,
            "device_busy_us_per_sample":
                prof["kernel_busy_ms_per_step"] * 1e3 / n_prof,
            "device_idle_share": prof["device_idle_share"],
            "top_kernels_us": prof["top_kernels_us"],
            "weight_bytes_per_sample": weight_bytes,
            "weight_bound_us_per_sample": weight_bytes / HBM_BYTES_PER_S
            * 1e6, "served_vs_loop_codes_apart": served_err}
    stage("profile_s")

    # the card's samples against the CPU: teacher-forced logits on the same
    # sampled sequence, and the same draws from the CPU's logits
    x_in = gen.previous_samples(samples)
    cpu = setup_generator(load_config(voc["config"]))
    cpu.load_state_dict(torch.load(voc["checkpoint"], map_location="cpu",
                                   weights_only=True)["model"])
    cpu.eval()
    with torch.no_grad():
        logits_card = gen(x_in, mel_p).cpu()
        logits_cpu = cpu(x_in.cpu(), mel_p.cpu())
    err = float((logits_card - logits_cpu).abs().max())
    scale = float(logits_cpu.abs().max())
    assert err <= TOL * scale, (err, scale)
    redrawn = W.draw_bits(logits_cpu, u[0].cpu())
    differ = redrawn != samples.cpu()
    near = W.boundary_distance(logits_cpu, u[0].cpu()) < 1e-5
    assert not bool((differ & ~near).any()), int(differ.sum())
    assert len(torch.unique(samples)) > 64
    stage("card_vs_cpu_s")

    # one mold request (10 mixtures)
    mold = build_wavernn(root, mode="mold", name="wavernn_mold")
    synth_mold = Synthesizer(paths["tts"], paths["tts_config"],
                             mold["checkpoint"], mold["config"], device=dev)
    assert synth_mold.vocoder_model.n_classes == 30
    t0 = time.perf_counter()
    wav = synth_mold.tts(WAVERNN_TEXTS[0])
    mold_ms = (time.perf_counter() - t0) * 1e3
    assert len(wav) == frames[0] * hop + 10000
    assert np.isfinite(wav).all() and np.abs(wav).max() > 1e-3
    stage("mold_s")
    log({"wavernn_serving": "glow_tts_ljspeech.json -> wavernn (bits 10)",
         "requests": requests, "launches": launches,
         "cli_launches": cli_launches, "sample_loop": loop,
         "logits_card_vs_cpu_max_abs": err,
         "logits_scale": scale, "ids_differing": int(differ.sum()),
         "draws_within_1e-5_of_a_boundary": int(near.sum()),
         "mold_request_ms": mold_ms, "stages_s": stages,
         "phase_s": time.perf_counter() - t_phase, "card": card})
    return {"paths": paths, "voc": voc,
            "reference": (WAVERNN_TEXTS[0], reference)}


def eval_model_phase(dev, root: str, card: str) -> dict:
    """Phase 27: bin/eval_model on the card on seeded full-width Glow-TTS
    and Tacotron2 checkpoints, against the CPU."""
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.bin.eval_model import evaluate, main as eval_main
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.data import TTSDataset, load_meta_data
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import mas as MAS
    from tts_tpu_torch.text import num_symbols

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    corpus = write_corpus(os.path.join(root, "eval_corpus"), EVAL_UTTERANCES)
    out = {}
    for name in ("glow_tts_ljspeech", "tacotron2_ljspeech"):
        c = load_config(os.path.join(here, "configs", f"{name}.json"))
        c["datasets"] = [{"name": "ljspeech", "path": corpus,
                          "meta_file_train": "metadata.csv",
                          "meta_file_val": "metadata.csv"}]
        cfg_path = os.path.join(root, f"eval_{name}.json")
        with open(cfg_path, "w") as f:
            json.dump(c, f)
        torch.manual_seed(SEED)
        model = setup_model(num_symbols(c["use_phonemes"]), 1, c)
        ckpt = os.path.join(root, f"eval_{name}.pt")
        torch.save({"model": model.state_dict()}, ckpt)
        # what the batches hold: full batches of 8, texts padded to 32
        items = load_meta_data(c["datasets"])[1][:EVAL_UTTERANCES]
        ds = TTSDataset(AudioProcessor(**c.audio), items,
                        outputs_per_step=getattr(model, "r", 1),
                        text_cleaner=c.get("text_cleaner",
                                           "english_cleaners"),
                        use_phonemes=c["use_phonemes"])
        text_buckets = [b["text"].shape[1] for b in ds.batches(8)]
        build.reset_launches()
        t0 = time.perf_counter()
        got = eval_main(["--config_path", cfg_path, "--checkpoint", ckpt,
                         "--num_items", str(EVAL_UTTERANCES)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        if name.startswith("glow"):
            assert launches.get(MAS.KERNEL, 0) == len(text_buckets), launches
            assert launches.get(BLK.KERNEL, 0) == 0, launches
        else:
            want = sum(1 + t for t in text_buckets)
            assert launches.get(BLK.KERNEL, 0) == want, (launches, want)
            assert launches.get(MAS.KERNEL, 0) == 0, launches
        cpu = evaluate(cfg_path, ckpt, num_items=EVAL_UTTERANCES,
                       device="cpu")
        assert got["n_items"] == cpu["n_items"] == EVAL_UTTERANCES
        apart = {}
        for key, value in cpu.items():
            if isinstance(value, float):
                apart[key] = abs(got[key] - value) / max(abs(value), 1e-12)
                assert apart[key] <= 1e-4, (key, got[key], value)
        out[name] = launches
        log({"eval_model": name, "metrics": got, "launches": launches,
             "text_buckets": text_buckets, "seconds": seconds,
             "s_per_item": seconds / EVAL_UTTERANCES,
             "card_vs_cpu_relative": apart, "card": card})
    log({"eval_model_phase_s": time.perf_counter() - t_phase})
    return out


def tools_phase(dev, root: str, card: str, wavernn: dict) -> None:
    """Phase 28: bin/compute_statistics on the eval corpus, and
    bin/convert_torch_checkpoint on .pth.tar files of phase 3's
    Multiband-MelGAN and phase 26's WaveRNN (``wavernn``, what
    ``wavernn_phase`` returns), served against the originals: the
    Multiband-MelGAN's request served from both checkpoints, the WaveRNN's
    against phase 26's audio of the same request."""
    from tts_tpu_torch.audio import AudioProcessor
    from tts_tpu_torch.bin.compute_statistics import main as stats_main
    from tts_tpu_torch.bin.convert_torch_checkpoint import main as convert
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.data import load_meta_data
    from tts_tpu_torch.infer.synthesizer import Synthesizer

    t_phase = time.perf_counter()
    cfg_path = os.path.join(root, "eval_glow_tts_ljspeech.json")
    c = load_config(cfg_path)
    out = os.path.join(root, "scale_stats.npy")
    t0 = time.perf_counter()
    stats = stats_main(["--config_path", cfg_path, "--out_path", out])
    stats_s = time.perf_counter() - t0
    # the same statistics from every frame at once, two-pass in float64:
    # the script's one pass of float32 sums (tts_tpu's) loses ~1e-4 of the
    # standard deviation to cancellation, its mean far less
    ap = AudioProcessor(**dict(c.audio, signal_norm=False, stats_path=None))
    items = load_meta_data(c["datasets"], eval_split_size=0.0)[0]
    mels, lins = [], []
    for _, wav_path, _ in items:
        wav = ap.load_wav(wav_path)
        mels.append(ap.melspectrogram(wav))
        lins.append(ap.spectrogram(wav))
    stats_apart = {}
    for key, frames in (("mel", np.concatenate(mels)),
                        ("linear", np.concatenate(lins))):
        frames = frames.astype(np.float64)
        for stat, want, tol in (("mean", frames.mean(0), 1e-5),
                                ("std", frames.std(0), 1e-3)):
            got = stats[f"{key}_{stat}"].astype(np.float64)
            rel = float((np.abs(got - want) / np.abs(want).clip(1e-6)).max())
            stats_apart[f"{key}_{stat}"] = rel
            assert rel <= tol, (key, stat, rel)
    AudioProcessor(**dict(c.audio, stats_path=out))

    paths, voc = wavernn["paths"], wavernn["voc"]
    wavernn_text, reference = wavernn["reference"]
    converted = []
    for model_type, ckpt, voc_cfg, text in (
            ("multiband_melgan", paths["voc"], paths["vocoder_config"],
             "Hello world!"),
            ("wavernn", voc["checkpoint"], voc["config"], wavernn_text)):
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        src = os.path.join(root, f"{model_type}.pth.tar")
        torch.save({"model": sd, "step": 1}, src,
                   _use_new_zipfile_serialization=False)
        t0 = time.perf_counter()
        new = convert(["--model_type", model_type, "--torch_checkpoint", src,
                       "--out_dir", os.path.join(root, "converted"),
                       "--config_path", voc_cfg])
        convert_s = time.perf_counter() - t0
        got = Synthesizer(paths["tts"], paths["tts_config"], new, voc_cfg,
                          device=dev).tts(text)
        if model_type == "wavernn":
            # the original checkpoint's audio of this request: phase 26's
            assert len(got) == len(reference) + 10000, len(got)
            want, got = reference, got[:len(reference)]
        else:
            want = Synthesizer(paths["tts"], paths["tts_config"], ckpt,
                               voc_cfg, device=dev).tts(text)
        err = float(np.abs(want - got).max())
        assert len(want) == len(got) and err <= 1e-5, err
        converted.append({"model_type": model_type, "convert_s": convert_s,
                          "served_max_abs_diff": err,
                          "samples": len(want)})
    log({"compute_statistics_s": stats_s, "stats_items": len(items),
         "stats_vs_float64_two_pass_relative": stats_apart,
         "converted": converted, "phase_s": time.perf_counter() - t_phase,
         "card": card})


def export_phase(dev, root: str, card: str, paths: dict) -> None:
    """Phase 29: phase 3's full-width Multiband-MelGAN and Glow-TTS
    (``paths`` from ``build_models``) exported on the CPU through
    bin/export_model, loaded and run on the card against the served kernel
    path (B1/B2, B3), whose launches are asserted."""
    from tts_tpu_torch.bin.export_model import main as export_main
    from tts_tpu_torch.export import load_program, max_abs_diff, run_program
    from tts_tpu_torch.infer.synthesizer import Synthesizer
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK

    t_phase = time.perf_counter()
    synth = Synthesizer(paths["tts"], paths["tts_config"], paths["voc"],
                        paths["vocoder_config"], device=dev)
    results = []
    for kind, ckpt, cfg, flags, kernels in (
            ("vocoder", paths["voc"], paths["vocoder_config"],
             ["--frames", str(MEL_FRAMES), "--batch", "2"],
             (M.PROJ_IN, M.UPSAMPLE, R.KERNEL, M.TAIL)),
            ("tts", paths["tts"], paths["tts_config"],
             ["--frames", "96", "--y_max_length", "1024"], (GEK.KERNEL,))):
        pt2 = os.path.join(root, f"{kind}.pt2")
        exported = export_main(["--config_path", cfg, "--checkpoint_path",
                                ckpt, "--output_path", pt2, "--kind", kind]
                               + flags)
        program = load_program(pt2)
        g = torch.Generator().manual_seed(SEED)
        build.reset_launches()
        if kind == "vocoder":
            args = (torch.randn(2, MEL_FRAMES, 80, generator=g),)
            with torch.no_grad():
                want = M.megakernel_inference(synth.vocoder_model,
                                              synth._packed,
                                              args[0].to(dev))[..., 0]
        else:
            args = (torch.randint(1, 60, (1, 96), generator=g),
                    torch.tensor([80], dtype=torch.int32))
            want = synth.model.inference(
                args[0].to(dev), args[1].to(dev), noise_scale=0.0,
                y_max_length=1024)["model_outputs"]
        launches = dict(build.LAUNCHES)
        for name in kernels:
            assert launches.get(name, 0) > 0, (kind, name, launches)
        got = run_program(program, *args, device=dev)
        assert got.device.type == dev.type, (kind, got.device)
        err = max_abs_diff(got, want)
        scale = float(want.abs().max())
        assert got.shape == want.shape, (got.shape, want.shape)
        assert err <= TOL * scale, (kind, err, scale)
        results.append({"kind": kind, "export_s": exported["export_s"],
                        "pt2_bytes": os.path.getsize(pt2),
                        "ran_on": str(got.device),
                        "kernel_path_launches": launches,
                        "vs_kernel_path_max_abs": err, "scale": scale})
    log({"export": results, "phase_s": time.perf_counter() - t_phase,
         "card": card})


# ---------------------------------------------------------------------------
# phase 30: multi-device
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_TRAIN_STEPS = 3           # train-mode steps after which ranks must agree
DP_GLOW = (32, 64, 256)      # global batch, symbols, frames (one length)
DP_TACO = (64, 64, 224)      # global batch, symbols, frames (r 7: 32 steps)
DP_GAN_BATCH = 64            # x the config's 16,384 samples
DP_SERVE = (8, 128)          # phase 4's geometry (248 frames) at batch 8
DP_SHARD_BATCH = 2
DP_LOSS_RTOL, DP_ATOL, DP_RTOL = 1e-5, 1e-6, 1e-4   # tts_tpu's tolerances
LAUNCH_EPOCHS = 2            # the shipped Tacotron2 through the launcher


def _repo_config(name: str) -> dict:
    """A repo config as plain dicts (what torch.load(weights_only=True)
    reads back)."""
    from tts_tpu_torch.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    return json.loads(json.dumps(load_config(
        os.path.join(here, "configs", f"{name}.json"))))


def _tts_batch(n: int, t_text: int, t_mel: int, seed: int, n_chars: int,
               r: int = 1) -> dict:
    """Items of one length (so the ranks' masked means compose to the
    batch's), seeded, on the host: text ids, time-major mel, stop targets
    grouped by r."""
    g = torch.Generator().manual_seed(seed)
    stop = torch.zeros(n, t_mel // r)
    stop[:, -1] = 1.0
    return {"text": torch.randint(1, n_chars, (n, t_text), generator=g),
            "text_lengths": torch.full((n,), t_text, dtype=torch.int32),
            "mel": torch.randn(n, t_mel, 80, generator=g),
            "mel_lengths": torch.full((n,), t_mel, dtype=torch.int32),
            "stop_targets": stop}


def dp_inputs(kinds=("glow", "taco", "gan", "serve", "shard"),
              gan_batch: int = DP_GAN_BATCH) -> dict:
    """The seeded full-width models and global batches of the DP checks, on
    the host: Glow-TTS, Tacotron2 (fp32) and Multiband-MelGAN (fp32) from
    the repo's configs; each optimizer at the config's learning rate
    without warmup, so one update stands above tts_tpu's atol of 1e-6."""
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.models.vocoder.registry import (setup_discriminator,
                                                       setup_generator)
    from tts_tpu_torch.text import num_symbols
    out = {}
    if "glow" in kinds:
        c = _repo_config("glow_tts_ljspeech")
        c["noam_schedule"] = False
        torch.manual_seed(SEED)
        n_chars = num_symbols(c.get("use_phonemes", False))
        m = setup_model(n_chars, 1, c)
        b = _tts_batch(*DP_GLOW, seed=1, n_chars=n_chars)
        b["mel"] = b["mel"].transpose(1, 2).contiguous()
        del b["stop_targets"]
        out["glow"] = {"config": c, "state": m.state_dict(), "batch": b}
    if "taco" in kinds:
        c = _repo_config("tacotron2_ljspeech")
        c["mixed_precision"] = False
        torch.manual_seed(SEED)
        n_chars = num_symbols(c.get("use_phonemes", False))
        m = setup_model(n_chars, 1, c)
        out["taco"] = {"config": c, "state": m.state_dict(),
                       "batch": _tts_batch(*DP_TACO, seed=2, n_chars=n_chars,
                                           r=m.r)}
    voc = _repo_config("multiband_melgan")
    voc["mixed_precision"] = False
    if "gan" in kinds:
        torch.manual_seed(SEED)
        gen, disc = setup_generator(voc), setup_discriminator(voc)
        g = torch.Generator().manual_seed(3)
        frames = voc["seq_len"] // voc["audio"]["hop_length"]
        batch = {s: {"mel": torch.randn(gan_batch, 80, frames, generator=g),
                     "audio": 0.3 * torch.randn(gan_batch, 1, voc["seq_len"],
                                                generator=g)}
                 for s in "GD"}
        out["gan"] = {"config": voc, "G": gen.state_dict(),
                      "D": disc.state_dict(), "batch": batch}
    if "serve" in kinds or "shard" in kinds:
        torch.manual_seed(SEED)
        voc_sd = setup_generator(voc).state_dict()
    if "serve" in kinds:
        c = _repo_config("glow_tts_ljspeech")
        torch.manual_seed(SEED)
        glow = setup_model(128, 1, c)
        n, t_text = DP_SERVE
        g = torch.Generator().manual_seed(4)
        out["serve"] = {"config": c, "glow": glow.state_dict(),
                        "frames": MEL_FRAMES,
                        "voc_config": voc, "voc": voc_sd,
                        "text": torch.randint(1, 128, (n, t_text),
                                              generator=g),
                        "lengths": torch.full((n,), t_text,
                                              dtype=torch.int32)}
    if "shard" in kinds:
        g = torch.Generator().manual_seed(5)
        out["shard"] = {"voc_config": voc, "voc": voc_sd,
                        "mel": torch.randn(DP_SHARD_BATCH, 80, MEL_FRAMES,
                                           generator=g)}
    return out


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _host_state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def _digest(*modules) -> str:
    import hashlib
    h = hashlib.sha256()
    for m in modules:
        for k, v in m.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def _glow(spec, dev):
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train.optim import make_optimizer
    c = spec["config"]
    m = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    m.load_state_dict(spec["state"])
    m = m.to(dev)
    return m, make_optimizer(m, lr=c["lr"], grad_clip=c.get("grad_clip", 5.0))


def _taco(spec, dev):
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.text import num_symbols
    from tts_tpu_torch.train.optim import make_optimizer
    from tts_tpu_torch.train.trainer_tts import loss_kwargs_from_config
    c = spec["config"]
    m = setup_model(num_symbols(c.get("use_phonemes", False)), 1, c)
    m.load_state_dict(spec["state"])
    m = m.to(dev)
    return (m, make_optimizer(m, lr=c["lr"], grad_clip=c.get("grad_clip",
                                                               5.0)),
            dict(loss_kwargs_from_config(c), r=m.r))


def _gan(spec, dev, mesh=None):
    from tts_tpu_torch.models.vocoder.registry import (setup_discriminator,
                                                       setup_generator)
    from tts_tpu_torch.train.trainer_vocoder import make_gan_step
    c = spec["config"]
    gen, disc = setup_generator(c), setup_discriminator(c)
    gen.load_state_dict(spec["G"])
    disc.load_state_dict(spec["D"])
    gen, disc = gen.to(dev).train(), disc.to(dev).train()
    return gen, disc, make_gan_step(c, gen, disc, dev, mesh=mesh)


def _serving_fn(spec, dev):
    """phase 4's pipeline, noise 0: ids -> Glow-TTS (B3) -> the vocoder
    kernel chain (B1/B2)."""
    from tts_tpu_torch.models.registry import setup_model
    from tts_tpu_torch.models.vocoder.fold import fold_weight_norm
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    glow = setup_model(128, 1, spec["config"])
    glow.load_state_dict(spec["glow"])
    glow = glow.to(dev).eval()
    glow.store_inverse()
    voc = setup_generator(spec["voc_config"])
    voc.load_state_dict(spec["voc"])
    packed = M.pack_generator_params(voc, fold_weight_norm(voc.state_dict()),
                                     dev)

    @torch.no_grad()
    def synthesize(text, lengths):
        out = glow.inference(text, lengths, noise_scale=0.0,
                             y_max_length=spec["frames"])
        mel = out["model_outputs"].float().contiguous()
        return M.megakernel_generator_apply(voc, packed, mel)

    return synthesize


def _launched():
    from tts_tpu_torch.ops.cuda import build
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return dict(build.LAUNCHES)


def dp_run(inputs: dict, dev, mesh=None) -> dict:
    """The checks' work on this process: with ``mesh``, the DP steps on
    this rank's contiguous part of each global batch (a world of its ranks),
    else the single-process steps on the whole batches. Per model: the
    losses, the state after one step in eval mode (Glow after its DDI pass
    on the global batch, Tacotron2 with no dropout, the GAN as it trains),
    the launches of that part; then the ms of each of DP_TRAIN_STEPS more
    steps in train mode (the host's clock around a synchronised step), and
    with ``mesh`` a digest of the state after them."""
    from tts_tpu_torch.models.glow_tts import apply_ddi
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.parallel import (make_dp_train_step,
                                        make_glow_dp_train_step, replicate)
    from tts_tpu_torch.parallel.data_parallel import shard_batch
    from tts_tpu_torch.train.trainer_glow import train_step as glow_step
    from tts_tpu_torch.train.trainer_tts import train_step as taco_step

    def part(batch):
        return batch if mesh is None else shard_batch(batch, mesh)

    def timed(step, n=DP_TRAIN_STEPS):
        ms = []
        for _ in range(n):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return ms

    out = {}
    if "glow" in inputs:
        m, opt = _glow(inputs["glow"], dev)
        batch = _on(inputs["glow"]["batch"], dev)
        build.reset_launches()
        apply_ddi(m.eval(), batch)
        if mesh is None:
            losses = glow_step(m, opt, batch)
        else:
            replicate(m, mesh)
            losses = make_glow_dp_train_step(m, opt, mesh, train=False)(
                part(batch))
        out["glow"] = {"losses": losses, "launches": _launched(),
                       "state": _host_state(m)}
        if mesh is None:
            out["glow"]["ms"] = timed(lambda: glow_step(m.train(), opt,
                                                        batch))
        else:
            step = make_glow_dp_train_step(m, opt, mesh, seed=SEED)
            out["glow"]["ms"] = timed(lambda: step(part(batch)))
            out["glow"]["digest"] = _digest(m)
        del m, opt
    if "taco" in inputs:
        m, opt, kw = _taco(inputs["taco"], dev)
        batch = _on(inputs["taco"]["batch"], dev)
        build.reset_launches()
        if mesh is None:
            # as the DP step's eval mode: cuDNN's RNN has no eval backward
            with torch.backends.cudnn.flags(enabled=False):
                losses = taco_step(m.eval(), opt, batch, kw)
        else:
            losses = make_dp_train_step(m, opt, mesh, kw, train=False)(
                part(batch))
        out["taco"] = {"losses": losses, "launches": _launched(),
                       "state": _host_state(m)}
        if mesh is None:
            out["taco"]["ms"] = timed(lambda: taco_step(m.train(), opt,
                                                        batch, kw))
        else:
            step = make_dp_train_step(m, opt, mesh, kw, seed=SEED)
            out["taco"]["ms"] = timed(lambda: step(part(batch)))
            out["taco"]["digest"] = _digest(m)
        del m, opt
    if "gan" in inputs:
        gen, disc, step = _gan(inputs["gan"], dev, mesh)
        b = {s: part(_on(inputs["gan"]["batch"][s], dev)) for s in "GD"}
        build.reset_launches()
        losses = step(b["G"], b["D"], train_disc=True)
        out["gan"] = {"losses": losses, "launches": _launched(),
                      "state": {"G": _host_state(gen),
                                "D": _host_state(disc)}}
        out["gan"]["ms"] = timed(lambda: step(b["G"], b["D"],
                                              train_disc=True))
        if mesh is not None:
            out["gan"]["digest"] = _digest(gen, disc)
        del gen, disc, step
    return out


def dp_serve(inputs: dict, dev, mesh=None) -> dict:
    """Batch DP_SERVE through make_dp_serving over ``mesh`` (or the plain
    call), and with ``inputs["shard"]`` and a mesh the channel-sharded
    generator over a (data 1, model world) mesh (or the unsharded one)."""
    from tts_tpu_torch.infer.serving_dp import make_dp_serving
    from tts_tpu_torch.models.vocoder.registry import setup_generator
    from tts_tpu_torch.ops.cuda import build
    out = {}
    if "serve" in inputs:
        spec = inputs["serve"]
        fn = _serving_fn(spec, dev)
        if mesh is not None:
            fn = make_dp_serving(fn, mesh)
        text, lengths = _on(spec["text"], dev), _on(spec["lengths"], dev)
        fn(text, lengths)                   # warm
        build.reset_launches()
        t0 = time.perf_counter()
        wav = fn(text, lengths)
        launches = _launched()
        out["serve"] = {"wav": wav.cpu(), "launches": launches,
                        "ms": 1e3 * (time.perf_counter() - t0)}
    if "shard" in inputs:
        spec = inputs["shard"]
        gen = setup_generator(spec["voc_config"])
        gen.load_state_dict(spec["voc"])
        gen = gen.to(dev).eval()
        mel = _on(spec["mel"], dev)
        if mesh is None:
            with torch.no_grad():
                wav = gen.pqmf.synthesis(gen(mel))
            out["shard"] = {"wav": wav.cpu()}
        else:
            from tts_tpu_torch.parallel import make_mesh
            from tts_tpu_torch.parallel.model_parallel import (
                channel_shardings, make_sharded_generator_forward,
                shard_params)
            world = mesh["data"].size()
            mesh2 = make_mesh((("data", 1), ("model", world)))
            names = channel_shardings(gen, mesh2)
            fwd = make_sharded_generator_forward(shard_params(gen, mesh2),
                                                 mesh2)
            out["shard"] = {"wav": fwd(mel).cpu(), "sharded": names}
    return out


def dp_rank_main(argv) -> int:
    """One rank of phase 30's world: ``chip_smoke.py --dp-rank R --world N
    --url U --dir D [--backend B] [--device cpu]`` reads D/inputs.pt, writes
    D/rank<R>.pt."""
    import argparse

    from tts_tpu_torch.parallel import make_mesh
    from tts_tpu_torch.parallel.mesh import finalize, initialize_multihost
    p = argparse.ArgumentParser()
    p.add_argument("--dp-rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--url", required=True)
    p.add_argument("--dir", required=True)
    p.add_argument("--backend", default="gloo")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = initialize_multihost(a.url, a.world, a.dp_rank, backend=a.backend,
                               device=a.device)
    mesh = make_mesh()
    inputs = torch.load(os.path.join(a.dir, "inputs.pt"), weights_only=True)
    t0 = time.perf_counter()
    out = dp_run(inputs, dev, mesh)
    out.update(dp_serve(inputs, dev, mesh))
    out["seconds"] = time.perf_counter() - t0
    out["device"] = str(dev)
    torch.save(out, os.path.join(a.dir, f"rank{a.dp_rank}.pt"))
    finalize()
    return 0


def spawn_dp_ranks(workdir: str, world: int = DP_WORLD,
                   backend: str = "gloo", timeout_s: float = 600,
                   device=None) -> list:
    """``world`` ranks of dp_rank_main on this machine's card(s); their
    outputs in rank order. A rank that fails ends the others and raises
    with its log."""
    here = os.path.dirname(os.path.abspath(__file__))
    url = "file://" + os.path.join(workdir, "store")
    env = dict(os.environ, PYTHONPATH=here)
    procs, logs = [], []
    for r in range(world):
        logs.append(open(os.path.join(workdir, f"rank{r}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
             "--world", str(world), "--url", url, "--dir", workdir,
             "--backend", backend] + (["--device", device] if device
                                      else []),
            cwd=here, env=env, stdout=logs[r],
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        codes = [p.poll() for p in procs]
        if any(c != 0 for c in codes):
            for log_file in logs:
                log_file.seek(0)
            raise RuntimeError(f"DP ranks exited {codes}:\n" + "\n".join(
                f"--- rank {r}\n{f.read()[-4000:]}"
                for r, f in enumerate(logs)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def dp_compare(ranks: list, single: dict) -> dict:
    """Each rank's DP step against the single-process step (tts_tpu's
    tolerances: the total loss rtol 1e-5, every tensor of the state atol
    1e-6 rtol 1e-4), the per-rank launches against the single process's
    (the per-step rule of phases 6 and 8 is per rank), and the ranks'
    train-mode states bitwise equal. Returns the largest deviations."""
    summary = {}
    totals = {"glow": ("loss",), "taco": ("loss",),
              "gan": ("G_loss", "D_loss")}
    for kind, want in single.items():
        if kind not in totals:
            continue
        dev_loss, dev_state = 0.0, 0.0
        for rank in ranks:
            got = rank[kind]
            for key in totals[kind]:
                rel = abs(got["losses"][key] - want["losses"][key]) / abs(
                    want["losses"][key])
                dev_loss = max(dev_loss, rel)
                assert rel <= DP_LOSS_RTOL, (kind, key, got["losses"][key],
                                             want["losses"][key])
            states = ([(got["state"], want["state"])] if kind != "gan" else
                      [(got["state"][s], want["state"][s]) for s in "GD"])
            for g_sd, w_sd in states:
                assert set(g_sd) == set(w_sd), kind
                for name, w in w_sd.items():
                    if not w.is_floating_point():
                        assert torch.equal(g_sd[name], w), (kind, name)
                        continue
                    diff = (g_sd[name] - w).abs()
                    dev_state = max(dev_state, float(diff.max()))
                    assert bool((diff <= DP_ATOL + DP_RTOL * w.abs()).all()), \
                        (kind, name, float(diff.max()))
            assert got["launches"] == want["launches"], \
                (kind, got["launches"], want["launches"])
        assert len({r[kind]["digest"] for r in ranks}) == 1, kind
        summary[kind] = {"loss_rel_dev": dev_loss,
                         "state_max_abs_dev": dev_state,
                         "train_ms_per_step": {
                             "single": want["ms"],
                             **{f"rank{r}": rank[kind]["ms"]
                                for r, rank in enumerate(ranks)}},
                         "losses_dp_rank0": ranks[0][kind]["losses"],
                         "launches_per_rank": ranks[0][kind]["launches"],
                         "train_mode_steps_bitwise_equal": DP_TRAIN_STEPS}
    return summary


def _close_to(got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max())
    assert got.shape == want.shape and err <= TOL * float(want.abs().max()), \
        (tuple(got.shape), tuple(want.shape), err)
    return err


def multi_device_phase(dev, root: str, card: str, taco_per_r: dict) -> None:
    from tts_tpu_torch.config import load_config
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    from tts_tpu_torch.ops.cuda import grouped_conv_grad as GCK
    from tts_tpu_torch.ops.cuda import mas as MAS
    from tts_tpu_torch.ops.cuda import stft_mag as SK
    from tts_tpu_torch.parallel import make_mesh
    from tts_tpu_torch.parallel.mesh import finalize, initialize_multihost

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    # the ranks are processes of their own: hand them this one's cache
    torch.cuda.empty_cache()
    # 1. the shipped Tacotron2 config through the launcher, NCCL, 1 rank
    corpus = write_corpus(os.path.join(root, "LJSpeech"))
    c = load_config(os.path.join(here, "configs", "tacotron2_ljspeech.json"))
    assert c["use_data_parallel"] and c["mixed_precision"]
    c.update(datasets=[{"name": "ljspeech", "path": corpus,
                        "meta_file_train": "metadata.csv"}],
             phoneme_cache_path=os.path.join(root, "phoneme_cache"),
             epochs=LAUNCH_EPOCHS, run_eval=False, run_test_sentences=False,
             print_step=1)
    cfg_path = os.path.join(root, "tacotron2_dp.json")
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    runs = os.path.join(root, "dp_runs")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tts_tpu_torch.bin.distribute", "--script",
         "train_tts", "--num_processes", "1", "--", "--config_path",
         cfg_path, "--output_path", runs], cwd=here, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=here))
    launch_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    out = proc.stdout
    assert "torch.distributed: 1 rank(s), backend nccl, rank 0 on cuda:0" \
        in out, out[-3000:]
    losses = [float(v) for v in re.findall(r"\| > loss: (\S+)", out)]
    step_ms = [1e3 * float(v) for v in
               re.findall(r"\| > step_time: (\S+)", out)]
    assert losses and all(math.isfinite(v) for v in losses), losses
    [folder] = os.listdir(runs)
    written = sorted(f for f in os.listdir(os.path.join(runs, folder))
                     if f.endswith(".pt"))
    assert written == [f"checkpoint_{len(losses)}.pt"], written
    log({"phase": "multi_device", "launcher": "bin/distribute -> "
         "bin/train_tts, configs/tacotron2_ljspeech.json as shipped "
         "(use_data_parallel, r 7, batch 64, bf16), NCCL, 1 rank",
         "steps": len(losses), "losses": losses, "ms_per_step": step_ms,
         "phase14_single_process_ms_per_step_r7":
             taco_per_r and taco_per_r[7]["ms_per_step"],
         "checkpoints_written": written, "launch_s": launch_s, "card": card})

    # 2-4. the DP steps, serving and the sharded generator: gloo, 2 ranks
    # on this card, each against the single-process run on the same inputs
    workdir = os.path.join(root, "dp_world")
    os.makedirs(workdir)
    inputs = dp_inputs()
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    t0 = time.perf_counter()
    ranks = spawn_dp_ranks(workdir)
    world_s = time.perf_counter() - t0
    assert [r["device"] for r in ranks] == ["cuda:0"] * DP_WORLD
    single = dp_run(inputs, dev)
    single.update(dp_serve(inputs, dev))
    summary = dp_compare(ranks, single)
    assert single["glow"]["launches"] == {MAS.KERNEL: 2}, \
        single["glow"]["launches"]          # the DDI pass + one step
    assert single["taco"]["launches"] == {}, single["taco"]["launches"]
    want_gan = {SK.KERNEL: 12, GCK.DGRAD: 27, GCK.WGRAD: 18}
    assert single["gan"]["launches"] == want_gan, single["gan"]["launches"]
    serve_err = {}
    b123 = (R.KERNEL, M.PROJ_IN, M.UPSAMPLE, M.TAIL, GEK.KERNEL)
    for r, rank in enumerate(ranks):
        serve_err[f"gloo_rank{r}"] = _close_to(rank["serve"]["wav"],
                                               single["serve"]["wav"])
        assert rank["serve"]["launches"] == single["serve"]["launches"], \
            (rank["serve"]["launches"], single["serve"]["launches"])
    assert all(single["serve"]["launches"].get(k, 0) > 0 for k in b123), \
        single["serve"]["launches"]
    shard_err = [_close_to(rank["shard"]["wav"], single["shard"]["wav"])
                 for rank in ranks]
    assert ranks[0]["shard"]["sharded"] and all(
        r["shard"]["sharded"] == ranks[0]["shard"]["sharded"] for r in ranks)

    # 3. serving at an NCCL world of 1, in this process
    initialize_multihost("file://" + os.path.join(root, "nccl_store"), 1, 0,
                         backend="nccl")
    try:
        nccl = dp_serve({"serve": inputs["serve"]}, dev, make_mesh())
    finally:
        finalize()
    serve_err["nccl_1"] = _close_to(nccl["serve"]["wav"],
                                    single["serve"]["wav"])
    assert nccl["serve"]["launches"] == single["serve"]["launches"]
    log({"phase": "multi_device", "dp_steps": "gloo, 2 ranks on one card, "
         "full width, fp32, each rank against the single-process step on "
         "the global batch", "geometry": {"glow": DP_GLOW, "taco": DP_TACO,
                                          "gan_batch": DP_GAN_BATCH},
         "summary": summary, "world_s": world_s,
         "rank_s": [r["seconds"] for r in ranks], "card": card})
    log({"phase": "multi_device", "dp_serving": "Glow-TTS -> MB-MelGAN, "
         "batch 8 x 128 symbols, 248 frames, noise 0",
         "max_abs_err_vs_single": serve_err,
         "launches_per_rank": ranks[0]["serve"]["launches"],
         "launches_single": single["serve"]["launches"],
         "ms": {"single": single["serve"]["ms"],
                "nccl_1": nccl["serve"]["ms"],
                "gloo_2_rank0": ranks[0]["serve"]["ms"]},
         "channel_sharded_generator": {
             "model_dim": DP_WORLD, "max_abs_err": shard_err,
             "sharded_layers": ranks[0]["shard"]["sharded"]},
         "phase_s": time.perf_counter() - t_phase, "card": card})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tts_tpu_torch.ops.cuda import build
    from tts_tpu_torch.ops.cuda import fused_melgan as M
    from tts_tpu_torch.ops.cuda import fused_resstack as R

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    card = card_identity()
    log(card)  # as nvidia-smi prints it: name, power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{nvcc_version()}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = build.build_all()
    log({"kernel_build_s": built, "wall_s": time.perf_counter() - t0})
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    results = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        launches = serving_phase(dev, root)
    batched_phase(dev, card)
    mas = mas_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        trained = training_phase(dev, root, card)
    gan = gan_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        gan_launches = gan_training_phase(dev, root, card)
    taco = taco2_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        taco_launches = taco2_serving_phase(dev, root)
    taco2_batched_phase(dev, card)
    glow_enc = glow_encoder_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as root:
        cli_phase(dev, root)
    with tempfile.TemporaryDirectory() as root:
        taco_train = taco2_training_phase(dev, root, card)
    with tempfile.TemporaryDirectory() as root:
        prewarm_phase(root, card)
    with tempfile.TemporaryDirectory() as root:
        vocoders = {"pwgan": pwgan_training_phase(dev, root, card),
                    "istft": istft_training_phase(dev, root, card)}
        vocoder_serving_phase(dev, root, card, vocoders)
    with tempfile.TemporaryDirectory() as root:
        encoded = speaker_encoder_phase(dev, root, card)
        ms_runs = multispeaker_training_phase(dev, root, card, encoded)
        multispeaker_serving_phase(dev, root, card, encoded, ms_runs)
    with tempfile.TemporaryDirectory() as root:
        v1 = tacotron_v1_phase(dev, root, card)
        graves_phase(dev, root, card)
        streaming_phase(dev, root, card, v1)
        glow_encoders_phase(dev, root, card)
    with tempfile.TemporaryDirectory() as root:
        wavernn = wavernn_phase(dev, root, card)
        eval_model_phase(dev, root, card)
        tools_phase(dev, root, card, wavernn)
        export_phase(dev, root, card, wavernn["paths"])
    with tempfile.TemporaryDirectory() as root:
        multi_device_phase(dev, root, card, taco_train["per_r"])

    names = {
        R.KERNEL: ("tts_tpu_torch/ops/cuda/fused_resstack.cu",
                   "tts_tpu/ops/pallas/fused_resstack.py:127"),
        M.PROJ_IN: ("tts_tpu_torch/ops/cuda/fused_melgan.cu",
                    "tts_tpu/ops/pallas/fused_melgan.py:925"),
        M.UPSAMPLE: ("tts_tpu_torch/ops/cuda/fused_melgan.cu",
                     "tts_tpu/ops/pallas/fused_melgan.py:925"),
        M.TAIL: ("tts_tpu_torch/ops/cuda/fused_melgan.cu",
                 "tts_tpu/ops/pallas/fused_melgan.py:925"),
    }
    kernels = []
    for name, (source, replaces) in names.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]})
    from tts_tpu_torch.ops.cuda import mas as MAS
    kernels.append({"name": MAS.KERNEL, "route": "cuda",
                    "source": "tts_tpu_torch/ops/cuda/mas.cu",
                    "replaces": "tts_tpu/ops/pallas/mas_kernel.py:95",
                    "launches": trained["launches"],
                    "max_abs_err": mas["err"], "ms": mas["ms"],
                    "plain_ms": mas["plain_ms"], "bound_ms": mas["bound"][0],
                    "bound_by": mas["bound"][1], "library_ms": None})
    from tts_tpu_torch.ops.cuda import grouped_conv_grad as GCK
    from tts_tpu_torch.ops.cuda import stft_mag as SK
    for name, source, replaces in (
            (SK.KERNEL, "tts_tpu_torch/ops/cuda/stft_mag.cu",
             "tts_tpu/ops/pallas/stft_kernel.py:68"),
            (GCK.WGRAD, "tts_tpu_torch/ops/cuda/grouped_conv_grad.cu",
             "tts_tpu/ops/pallas/grouped_conv_grad.py:104"),
            (GCK.DGRAD, "tts_tpu_torch/ops/cuda/grouped_conv_grad.cu",
             "tts_tpu/ops/pallas/grouped_conv_grad.py:188")):
        r = gan[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": gan_launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]})
    from tts_tpu_torch.ops.cuda import bilstm as BLK
    from tts_tpu_torch.ops.cuda import taco2_decode as TDK
    for name, source, replaces in (
            (BLK.KERNEL, "tts_tpu_torch/ops/cuda/bilstm.cu",
             "tts_tpu/ops/pallas/fused_bilstm.py:90"),
            (TDK.KERNEL, "tts_tpu_torch/ops/cuda/taco2_decode.cu",
             "tts_tpu/ops/pallas/fused_taco2_decode.py:237")):
        r = taco[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": taco_launches[name],
                        "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1],
                        "library_ms": r["library_ms"]})
    from tts_tpu_torch.ops.cuda import glow_encoder as GEK
    kernels.append({"name": GEK.KERNEL, "route": "cuda",
                    "source": "tts_tpu_torch/ops/cuda/glow_encoder.cu",
                    "replaces": "tts_tpu/ops/pallas/fused_glow_encoder.py:293",
                    "launches": launches[GEK.KERNEL],
                    "max_abs_err": glow_enc["err"], "ms": glow_enc["ms"],
                    "plain_ms": glow_enc["plain_ms"],
                    "bound_ms": glow_enc["bound"][0],
                    "bound_by": glow_enc["bound"][1], "library_ms": None})
    log(card)  # as nvidia-smi prints it: name, power limit
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[1:]))
    sys.exit(main())
