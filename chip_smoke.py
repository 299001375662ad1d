"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (nvcc, sm_90a), checks each
against its plain torch version on the card, drives the main path (the
flagship ``random_bouncing`` scene at 512x512, 64 spp, depth 32, through
``render_fast(engine="auto")``) and shows through the launch counter that it
went through the kernel, then times it. One line per phase; the line before
the last is a JSON summary of the kernels, the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result; so does a machine without a GPU.
Imports torch, numpy and ``rayz_tpu_torch`` only (never JAX).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import rayz_tpu_torch as rtt
from rayz_tpu_torch.io.image import read_ppm, write_ppm
from rayz_tpu_torch.ops import _build, megakernel as mk, rng

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden_deterministic.ppm")

# tolerances (see PERF.md "Port on H100" for the measured values)
GOLDEN_MAX_STEP, GOLDEN_MAX_FRAC = 1, 0.005  # tests/test_golden.py allowance
DETERMINISTIC_ATOL = 1e-5   # kernel vs plain version, no random draws
STOCHASTIC_ATOL = 1e-4      # per channel, real random draws ...
STOCHASTIC_MAX_FRAC = 0.01  # ... on all but this share of channels
BLOCK_MEAN_ATOL = 0.01      # 8x8 block means, real random draws

FLAGSHIP = dict(width=512, height=512, spp=64, depth=32)
PLAIN_SPP = 4  # the plain version's spp cut at the flagship size
RUNS = 5


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


@contextlib.contextmanager
def plain_version():
    """Route the megakernel's launches to its plain torch version (on the
    same CUDA tensors) for a comparison run."""
    kernel = mk._trace_slots
    mk._trace_slots = mk._trace_slots_reference
    try:
        yield
    finally:
        mk._trace_slots = kernel


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def golden_check(img) -> tuple:
    buf = io.BytesIO()
    write_ppm(img, buf)
    u8 = read_ppm(io.BytesIO(buf.getvalue())).astype(np.int32)
    diff = np.abs(u8 - read_ppm(GOLDEN).astype(np.int32))
    step, frac = int(diff.max()), float((diff > 0).mean())
    if step > GOLDEN_MAX_STEP or frac >= GOLDEN_MAX_FRAC:
        raise AssertionError(f"golden drift: max step {step}, {frac:.4%} of "
                             "channels off")
    return step, frac


def golden_scene(dev):
    b = rtt.SceneBuilder()
    e = b.add_solid_texture((0.2, 0.3, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.5, e, o)
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_metallic(texture=checker, fuzz=0.0))
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.9, 0.6, 0.3),
                                                 fuzz=0.0))
    b.add_sphere((-1.1, 0, -2.4), 0.45, b.add_metallic(color=(0.6, 0.8, 0.9),
                                                       fuzz=0.0))
    b.add_triangle((0.6, -0.2, -1.6), (1.4, -0.2, -1.9), (1.0, 0.7, -1.8),
                   b.add_metallic(color=(0.8, 0.8, 0.8), fuzz=0.0))
    cam = rtt.make_camera(width=96, height=64, vfov=55.0, focus_dist=1.0,
                          defocus_angle=0.0, look_from=(0, 0.2, 0.6),
                          look_at=(0, 0, -2), device=dev)
    cfg = rtt.RenderConfig(spp=1, max_depth=8, jitter=False)
    return b.build(device=dev), cam, cfg


def agreement(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Share of channels differing by more than STOCHASTIC_ATOL, the largest
    difference, and the largest 8x8 block-mean difference."""
    d = (a - b).abs()
    h8, w8 = (a.shape[0] // 8) * 8, (a.shape[1] // 8) * 8
    blk = (a - b)[:h8, :w8].reshape(h8 // 8, 8, w8 // 8, 8, 3).mean((1, 3))
    return dict(frac=float((d > STOCHASTIC_ATOL).double().mean()),
                max_abs=float(d.max()), block=float(blk.abs().max()))


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: this smoke test runs "
                           "on an NVIDIA GPU only")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase("card", f"{smi} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | python {sys.version.split()[0]}")

    # ---- 2. build ----
    lib, info = _build.load()
    regs = [ln.strip() for ln in info.log.splitlines()
            if "registers" in ln or "spill" in ln]
    phase("build", f"{'compiled' if info.compiled else 'reused'} "
                   f"{info.path.name} in {info.seconds:.2f} s; "
                   + " | ".join(regs))

    # ---- 3. RNG: CUDA hash against ops/rng.py on 2^20 counters ----
    r = np.random.default_rng(0)
    n = 1 << 20
    cols = [torch.from_numpy(r.integers(lo, hi, n).astype(np.int32)).to(dev)
            for lo, hi in ((-1, 1 << 20), (0, 65), (0, 33), (0, 9))]
    pix, sample, bounce, draw = cols
    out = torch.empty(n, dtype=torch.int32, device=dev)
    seed = 12345
    _build.check(lib, lib.rayz_rng_bits(
        seed, *(c.data_ptr() for c in cols), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "rng_bits")
    key = rng.step_key(rng.slot_key(seed, pix), sample, bounce)
    want = torch.empty(n, dtype=torch.int64, device=dev)
    for d in range(9):
        sel = draw == d
        want[sel] = rng.draw_bits(key[sel], d)
    got = out.to(torch.int64) & rng.MASK
    bad = int((got != want).sum())
    if bad:
        raise AssertionError(f"rng: {bad} of {n} CUDA draws differ from "
                             "ops/rng.py")
    phase("rng", f"{n} counters: CUDA hash == torch hash bit for bit")

    # ---- 4. golden scene: kernel (single + compact) vs golden and plain ----
    scene, cam, cfg = golden_scene(dev)
    max_err = 0.0
    for label, sched in (("single", dict(passes=0)),
                         ("compact", dict(budget=2, passes=3))):
        img = rtt.render_megakernel(scene, cam, 0, cfg, **sched)
        torch.cuda.synchronize()
        step, frac = golden_check(img)
        with plain_version():
            ref = rtt.render_megakernel(scene, cam, 0, cfg, **sched)
        err = float((img - ref).abs().max())
        if err > DETERMINISTIC_ATOL:
            raise AssertionError(f"golden {label}: kernel vs plain max abs "
                                 f"{err} > {DETERMINISTIC_ATOL}")
        max_err = max(max_err, err)
        phase("golden", f"{label}: max step {step}, {frac:.4%} channels off "
                        f"golden; kernel vs plain max abs {err:.3g}")

    # ---- 5. random_bouncing 64x36, 16 spp, depth 8, real random bits ----
    scene, cam = rtt.scenes.random_bouncing(width=64, height=36, device=dev)
    cfg = rtt.RenderConfig(spp=16, max_depth=8)
    compact = rtt.render_fast(scene, cam, 3, cfg)
    single = rtt.render_megakernel(scene, cam, 3, cfg, passes=0)
    with plain_version():
        ref = rtt.render_megakernel(scene, cam, 3, cfg, passes=0)
    torch.cuda.synchronize()
    if not torch.equal(compact, single):
        raise AssertionError("compact != single launch on a stochastic config")
    agr = agreement(single, ref)
    if agr["frac"] >= STOCHASTIC_MAX_FRAC or agr["block"] > BLOCK_MEAN_ATOL:
        raise AssertionError(f"random_bouncing kernel vs plain: {agr}")
    max_err = max(max_err, agr["max_abs"])
    phase("stochastic", "random_bouncing 64x36 16spp d8: compact == single "
                        f"bit for bit; kernel vs plain: {agr['frac']:.4%} "
                        f"channels > {STOCHASTIC_ATOL}, max abs "
                        f"{agr['max_abs']:.3g}, 8x8 block means within "
                        f"{agr['block']:.3g}")

    # the triangle sweep with tables above 48 KB (the shared-memory opt-in)
    scene, cam = rtt.scenes.cornell_box(width=48, device=dev)
    cfg = rtt.RenderConfig(spp=4, max_depth=8)
    kimg = rtt.render_megakernel(scene, cam, 4, cfg, passes=0)
    with plain_version():
        ref = rtt.render_megakernel(scene, cam, 4, cfg, passes=0)
    agr = agreement(kimg, ref)
    if agr["frac"] >= STOCHASTIC_MAX_FRAC or agr["block"] > BLOCK_MEAN_ATOL:
        raise AssertionError(f"cornell_box kernel vs plain: {agr}")
    max_err = max(max_err, agr["max_abs"])
    n_pad, m_pad = rtt.ops.tables._smem_scene_inputs(scene, 16)[2:]
    phase("stochastic", f"cornell_box 48x48 4spp d8 "
                        f"({rtt.ops.tables.shared_bytes(n_pad, m_pad)} B of "
                        f"tables): kernel vs plain {agr['frac']:.4%} channels "
                        f"> {STOCHASTIC_ATOL}, max abs {agr['max_abs']:.3g}")

    # ---- 6. the main path: flagship through render_fast(engine="auto") ----
    f = FLAGSHIP
    scene, cam = rtt.scenes.random_bouncing(width=f["width"],
                                            height=f["height"], device=dev)
    cfg = rtt.RenderConfig(spp=f["spp"], max_depth=f["depth"])
    rays = f["width"] * f["height"] * f["spp"]
    mk.LAUNCHES = 0
    img = rtt.render_fast(scene, cam, 1, cfg, engine="auto")
    torch.cuda.synchronize()
    launches = mk.LAUNCHES
    if launches != 10:
        raise AssertionError(f"main path made {launches} kernel launches, "
                             "expected the 10 compact passes")
    if not (bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
            and img.shape == (f["height"], f["width"], 3)):
        raise AssertionError("flagship image not finite/non-negative/shaped")
    phase("flagship", f"render_fast(auto): {launches} kernel launches, image "
                      f"{tuple(img.shape)} finite, mean {float(img.mean()):.4f}")

    mrays = {}
    for label, sched in (("compact", {}), ("single", dict(passes=0))):
        def run(seed, sched=sched):
            return rtt.render_fast(scene, cam, seed, cfg, **sched)
        timed(lambda: run(0))  # warm-up
        secs = [timed(lambda s=s: run(s))[1] for s in range(1, RUNS + 1)]
        mrays[label] = [rays / s / 1e6 for s in secs]
        phase("flagship", f"{label}: Mrays/s median "
                          f"{statistics.median(mrays[label]):.3f} (runs "
                          + ", ".join(f"{m:.3f}" for m in mrays[label])
                          + f"; {RUNS} after 1 warm-up) | {smi}")

    # kernel against the plain version at the flagship size, spp cut
    pcfg = rtt.RenderConfig(spp=PLAIN_SPP, max_depth=f["depth"])
    prays = f["width"] * f["height"] * PLAIN_SPP

    def kernel_run():
        return rtt.render_megakernel(scene, cam, 1, pcfg, passes=0)

    def plain_run():
        with plain_version():
            return rtt.render_megakernel(scene, cam, 1, pcfg, passes=0)

    kernel_run()
    kimg, k_s = timed(kernel_run)
    pimg, p_s = timed(plain_run)
    agr = agreement(kimg, pimg)
    phase("plain", f"512x512 {PLAIN_SPP}spp d{f['depth']} single launch: "
                   f"kernel {k_s * 1e3:.2f} ms ({prays / k_s / 1e6:.3f} "
                   f"Mrays/s), plain torch {p_s * 1e3:.2f} ms "
                   f"({prays / p_s / 1e6:.3f} Mrays/s); kernel vs plain "
                   f"{agr['frac']:.4%} channels > {STOCHASTIC_ATOL}, 8x8 "
                   f"block means within {agr['block']:.3g}, max abs "
                   f"{agr['max_abs']:.3g}")
    if agr["frac"] >= STOCHASTIC_MAX_FRAC or agr["block"] > BLOCK_MEAN_ATOL:
        raise AssertionError(f"flagship kernel vs plain: {agr}")
    max_err = max(max_err, agr["max_abs"])

    tables = rtt.ops.tables
    n_pad, m_pad = tables._smem_scene_inputs(scene, 8)[2:]
    phase("shared", f"flagship tables in shared memory: "
                    f"{tables.shared_bytes(n_pad, m_pad)} bytes per block")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "megakernel",
        "route": "cuda",
        "source": "rayz_tpu_torch/csrc/megakernel.cu",
        "replaces": "rayz_tpu/ops/megakernel.py:459",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_s * 1e3,
        "plain_ms": p_s * 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
