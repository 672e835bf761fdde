"""The wide-head-dim flash forward on the card, taken apart: where a
block's time goes in the tile loop, and the exchange that was measured
beside the kept one.

    python -m splatt3r_slam_tpu_torch.scripts.probe_wide_forward
        [--rounds 5]

Two altered copies of `csrc/flash_attention.cu` are written under
`_build/probe_wide/` and built with nvcc beside the checkout's own
library:

- `phases`: both wide kernels (`flash_fwd_wide_bf16`, `flash_fwd_wide_f32`)
  with the SM's clock read by thread 0 of every block around each step of
  the tile loop, the steps' cycles summed over the blocks into a device
  array (`flash_probe_read` copies it out). The steps: `pref` (tile j + 1's
  owner loads issued), `consume` (P and the rescale factors read, v waited
  for, in fp32 v split transposed and P split, P·V issued), `scores` (the
  k slice waited for, in fp32 split, tile j + 2's contraction issued),
  `fin` (tile j + 1's partials added, the softmax formed, P pushed to every
  block), `retire` (P·V and the contraction waited for, fp32's O update,
  tile j + 2's partial written), `loads` (the block barrier, the next
  copies issued) and `barrier` (the cluster barrier). Printed per row as
  cycles a block per tile, with the copy's device time beside the kept
  kernel's: the clock reads and their registers slow it.
- `allread`: the bf16 wide kernel with every block reading every block's
  partial of its own accumulator elements and forming the softmax itself
  (one cluster barrier a tile, p formed cs times, cs times the remote
  bytes of the owners' exchange), held against the plain version and
  timed in turns with the kept kernel.

Times are device times (`_common.time_calls`, 20 launches), in turns, the
median of `--rounds`. The alterations find their places by the source's
text and stop with an error where it has changed. Runs on the card only.
The last line of stdout is the result as JSON: {"rows": {row: {...}},
"device", "power_limit_w"}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess

import torch

from splatt3r_slam_tpu_torch import cuda_build, set_fp32_precision
from splatt3r_slam_tpu_torch.models import flash_attention as fl
from splatt3r_slam_tpu_torch.scripts._common import (device_fields,
                                                     time_calls)

# (label, B, n_q, n_kv, H, Dh): chip_smoke.py's wide rows
ROWS = (
    ("N768 H8 Dh512", 1, 768, 768, 8, 512),
    ("Nq256 Nkv512 H4 Dh384", 1, 256, 512, 4, 384),
    ("Nq256 Nkv512 H4 Dh512", 1, 256, 512, 4, 512),
    ("Nq256 Nkv512 H2 Dh1024", 1, 256, 512, 2, 1024),
    ("Nq256 Nkv512 H1 Dh1152", 1, 256, 512, 1, 1152),
)
PHASES = ("pref", "consume", "scores", "fin", "retire", "loads", "barrier")
BF16_BAR = 2 ** -7  # of the output's peak, as chip_smoke.py holds the kernel
RES_BAR = 1e-5
ITERS = 20

# the tile loop's steps: each ends after its line (`loads` before the
# cluster barrier's)
_AFTER = ("    if (j + 1 < tiles) own_pref(j + 1);\n", "    consume(j);\n",
          "    if (j + 2 < tiles) scores(j + 2);\n",
          "    if (j + 1 < tiles) own_fin(j + 1);\n",
          "    if (j + 2 < tiles) publish(j + 2);\n")
_BARRIER = ("    cluster_sync();  // P of tile j + 1 and the partials of tile "
            "j + 2 seen\n")
_LOOP = "  for (int j = 0; j < tiles; ++j) {\n"
_CLOCK = ("    {{ const uint32_t t_ = probe_clock(); pc_[{k}] += t_ - pt_; "
          "pt_ = t_; }}\n")


def _one(text, anchor):
    if text.count(anchor) != 1:
        raise RuntimeError(f"the source has changed: {anchor!r} found "
                           f"{text.count(anchor)} times")
    return text.index(anchor)


def _clocked(body, d):
    """A wide kernel's text with the step clocks in its tile loop, summed
    into flash_probe[d] by thread 0 after the loop."""
    i = _one(body, _LOOP)
    body = (body[:i] + "  uint32_t pc_[7] = {0, 0, 0, 0, 0, 0, 0}, "
            "pt_ = probe_clock(), p0_ = pt_;\n" + body[i:])
    for k, line in enumerate(_AFTER):
        i = _one(body, line) + len(line)
        body = body[:i] + _CLOCK.format(k=k) + body[i:]
    i = _one(body, _BARRIER)
    body = body[:i] + _CLOCK.format(k=5) + body[i:]
    i = _one(body, _BARRIER) + len(_BARRIER)
    body = body[:i] + _CLOCK.format(k=6) + body[i:]
    i = body.index("\n  }\n", i) + len("\n  }\n")
    return body[:i] + (
        "  if (tid == 0) {\n"
        "    for (int k = 0; k < 7; ++k)\n"
        f"      atomicAdd(&flash_probe[{d}][k], (unsigned long long)pc_[k]);\n"
        f"    atomicAdd(&flash_probe[{d}][7], "
        "(unsigned long long)(probe_clock() - p0_));\n"
        f"    atomicAdd(&flash_probe[{d}][8], 1ull);\n"
        f"    atomicAdd(&flash_probe[{d}][9], (unsigned long long)tiles);\n"
        "  }\n") + body[i:]


def _kernel_spans(src):
    a = _one(src, "__global__ void __launch_bounds__(WG, 2)\n"
                  "    flash_fwd_wide_bf16")
    b = _one(src, "// fp32: split TF32, kv tiles of WRS = 32 rows")
    c = _one(src, "__global__ void __launch_bounds__(WT, 1)\n"
                  "    flash_fwd_wide_f32")
    d = src.index("\n}\n", c) + 3
    return a, b, c, d


def phases_source(src):
    """The source with both wide kernels clocked (`phases`)."""
    a, b, c, d = _kernel_spans(src)
    out = (src[:a] + _clocked(src[a:b], 0) + src[b:c]
           + _clocked(src[c:d], 1) + src[d:])
    inc = '#include "flash_common.cuh"'
    i = _one(out, inc)
    out = (out[:i] + inc
           + "\n__device__ unsigned long long flash_probe[2][10];"
           "\n__device__ __forceinline__ uint32_t probe_clock() {\n"
           "  uint32_t c;\n  asm volatile(\"mov.u32 %0, %%clock;\" : "
           "\"=r\"(c));\n  return c;\n}" + out[i + len(inc):])
    return out + (
        "\n// the step clocks of both wide kernels: [dtype][7 steps, the "
        "loop, blocks, tiles]\n"
        'extern "C" int flash_probe_read(unsigned long long* out) {\n'
        "  return static_cast<int>(\n"
        "      cudaMemcpyFromSymbol(out, flash_probe, sizeof(flash_probe)));\n"
        "}\n\n"
        'extern "C" int flash_probe_reset() {\n'
        "  const unsigned long long zero[20] = {};\n"
        "  return static_cast<int>(\n"
        "      cudaMemcpyToSymbol(flash_probe, zero, sizeof(zero)));\n"
        "}\n")


# the bf16 wide kernel's tile loop and epilogue with every block reading
# every partial (`allread`), in place of the owners' exchange
_ALLREAD = r'''
  float mr[2] = {neg_inf(), neg_inf()}, lr[2] = {0.f, 0.f};
  // every block's partial of the thread's own elements, added in rank
  // order; the softmax; O rescaled; O += P V_j, left in flight
  auto consume = [&](int j) {
    float s[32];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q0 = 0; q0 < WCLUSTER; q0 += 4)
        if (q0 < cs) {
          float2 x[4][8];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const bool here = q0 + qq < cs;
            const uint32_t at = (here ? cluster_map(base, q0 + qq) : 0) +
                                WB_PART + (j & 1) * WPARTB + tid * 8;
#pragma unroll
            for (int kk = 0; kk < 8; ++kk)
              x[qq][kk] = here ? ld_dsmem(at + (8 * hf + kk) * 1024)
                               : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            if (q0 + qq < cs) {
#pragma unroll
              for (int kk = 0; kk < 8; ++kk) {
                const int k = 8 * hf + kk;
                s[2 * k] = q0 + qq == 0 ? x[qq][kk].x : s[2 * k] + x[qq][kk].x;
                s[2 * k + 1] =
                    q0 + qq == 0 ? x[qq][kk].y : s[2 * k + 1] + x[qq][kk].y;
              }
            }
        }
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = __fmul_rn(s[i], p.scale);
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(mr[r], quad_max(tmax[r]));
      alpha[r] = exp_ftz(mr[r] - mn);
      mr[r] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp_ftz(s[4 * nt] - mr[0]);
      const float p1 = exp_ftz(s[4 * nt + 1] - mr[0]);
      const float p2 = exp_ftz(s[4 * nt + 2] - mr[1]);
      const float p3 = exp_ftz(s[4 * nt + 3] - mr[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) lr[r] = lr[r] * alpha[r] + rs[r];
    if (!out) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
    bar_wait(vbars + 8 * (j & 1), (j >> 1) & 1);
    const uint32_t vt = base + WB_V + (j & 1) * WSL;
    hold(o);
    hold(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs128(o, pa[kk], desc_mn(vt + kk * 16 * 128, BOX));
    wg_commit();
  };

  if (!multi) bar_wait(qbar, 0);
  scores(0);
  wg_wait<0>();
  hold(sc);
  publish(0);
  __syncthreads();
  if (tid == 0 && !multi && tiles > 1) load_k(1);
  __syncwarp();
  cluster_sync();
  if (tiles > 1) scores(1);
  for (int j = 0; j < tiles; ++j) {
    wg_wait<1>();  // P V of tile j - 1
    hold(o);
    hold(pa);
    consume(j);
    if (j + 1 < tiles) {
      wg_wait<1>();  // S of tile j + 1
    } else {
      wg_wait<0>();
    }
    hold(sc);
    if (j + 1 < tiles) publish(j + 1);
    __syncthreads();
    if (tid == 0) {
      if (!multi && j + 2 < tiles) load_k(j + 2);
      if (out && j >= 1 && j + 1 < tiles) load_v(j + 1);
    }
    __syncwarp();
    cluster_sync();
    if (j + 2 < tiles) scores(j + 2);
  }
  wg_wait<0>();
  hold(o);
  const int row = q0 + warp * 16 + g;
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float ls = quad_sum(lr[hh]);
    inv[hh] = 1.f / ls;
    if (p.l != nullptr && rank == 0 && pass == 0 && c == 0) {
      const long long i =
          (static_cast<long long>(b) * gridDim.y + h) * p.n_q + row + 8 * hh;
      p.l[i] = ls;
      p.m[i] = mr[hh];
    }
  }
  if (out) {
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_b +
                        h * p.o_h + row * p.o_n + WC * gs + 2 * c;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(og + t * 8) =
          __floats2bfloat162_rn(o[4 * t] * inv[0], o[4 * t + 1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(og + 8 * p.o_n + t * 8) =
          __floats2bfloat162_rn(o[4 * t + 2] * inv[1],
                                o[4 * t + 3] * inv[1]);
    }
  }
  cluster_sync();
}

'''


def allread_source(src):
    """The source with the bf16 wide kernel's exchange replaced
    (`allread`)."""
    a = _one(src, "  // the units the block owns (eight a row): at most 512 "
                  "(cs 1) over 128\n")
    b = _one(src, "// fp32: split TF32, kv tiles of WRS = 32 rows")
    return src[:a] + _ALLREAD + src[b:]


def _start(name, text):
    """Write a copy of the source (with the header beside it) and start
    its nvcc → (library, process)."""
    source = cuda_build.KERNELS["flash_attention"][0]
    d = cuda_build.BUILD_DIR / "probe_wide" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / source.name).write_text(text)
    shutil.copy(source.parent / "flash_common.cuh", d)
    so = d / "libflash_attention.so"
    return so, subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
         str(d / source.name)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _registers(log, kernel):
    """(registers, spill store bytes) of `kernel` in a ptxas -v log."""
    m = re.search(rf"entry function '\w*{kernel}\w*'.*?(\d+) bytes spill "
                  r"stores.*?Used (\d+) registers", log, re.S)
    return (int(m.group(2)), int(m.group(1))) if m else None


def _with(entry, fn):
    """fn with the flash wrapper's launches going to `entry`."""
    def run():
        own = cuda_build._fns["flash_attention"]
        cuda_build._fns["flash_attention"] = entry
        try:
            return fn()
        finally:
            cuda_build._fns["flash_attention"] = own
    return run


def _in_turns(fns, rounds):
    """Device ms of each fn, in turns (the order flipped every round), the
    median over `rounds`."""
    got = [[] for _ in fns]
    for r in range(rounds):
        order = list(enumerate(fns))
        for i, fn in (order if r % 2 == 0 else order[::-1]):
            got[i].append(time_calls(fn, "cuda", ITERS)[0])
    return [statistics.median(x) for x in got]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_wide_forward runs on cuda: no card here")
    set_fp32_precision()
    src = cuda_build.KERNELS["flash_attention"][0].read_text()
    started = {name: _start(name, text) for name, text in (
        ("phases", phases_source(src)), ("allread", allread_source(src)))}
    own_log = cuda_build.build(["flash_attention"])["flash_attention"][1]
    libs, logs = {}, {"kept": own_log}
    for name, (so, proc) in started.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{err}")
        libs[name], logs[name] = so, out + err
    x = torch.zeros(1, 64, 1, 64, device="cuda", dtype=torch.bfloat16)
    fl.flash_attention(x, x, x, 0.125)  # resolves the kept entry point
    entries = {n: cuda_build._entry(so, "flash_attention")
               for n, so in libs.items()}
    probe = ctypes.CDLL(str(libs["phases"]))
    counts = (ctypes.c_ulonglong * 20)()
    for kernel in ("wide_bf16", "wide_f32"):
        print(f"[ptxas] flash_fwd_{kernel}: registers and spill store bytes "
              + ", ".join(f"{n} {_registers(log, kernel)}"
                          for n, log in logs.items()
                          if _registers(log, kernel)), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = {}
    for dt, di in (("bfloat16", 0), ("float32", 1)):
        for label, B, nq, nk, nh, D in ROWS:
            q, k, v = (torch.randn(B, n, nh, D, device="cuda",
                                   generator=gen).to(getattr(torch, dt))
                       for n in (nq, nk, nk))
            scale = D ** -0.5

            def fwd(q=q, k=k, v=v, scale=scale):
                return fl.flash_attention(q, k, v, scale)

            row = {}
            clocked = _with(entries["phases"], fwd)
            clocked()
            torch.cuda.synchronize()
            probe.flash_probe_reset()
            clocked()
            torch.cuda.synchronize()
            probe.flash_probe_read(counts)
            c = list(counts)[10 * di:10 * di + 10]
            row["cycles_per_tile"] = {p: c[i] / c[9]
                                      for i, p in enumerate(PHASES)}
            row["loop_cycles_per_tile"] = c[7] / c[9]
            row["blocks"] = c[8]
            fns = [fwd, clocked]
            if dt == "bfloat16":
                o, l, m = _with(entries["allread"], lambda: fl.flash_attention(
                    q, k, v, scale, residuals=True))()
                po, pl, pm = fl.flash_attention_torch(q, k, v, scale,
                                                      residuals=True)
                err = float((o.float() - po.float()).abs().max())
                row["allread_err"] = err
                row["allread_bar"] = BF16_BAR * float(po.float().abs().max())
                l_err = float(((l - pl).abs() / pl).max())
                m_err = float((m - pm).abs().max() / pm.abs().max())
                assert err <= row["allread_bar"] and max(l_err, m_err) <= \
                    RES_BAR, (label, err, l_err, m_err)
                fns.append(_with(entries["allread"], fwd))
            ms = _in_turns(fns, args.rounds)
            row["ms"], row["clocked_ms"] = ms[:2]
            if dt == "bfloat16":
                row["allread_ms"] = ms[2]
            key = f"{'bf16' if di == 0 else 'fp32'} {label}"
            rows[key] = row
            print(f"[probe] {key}: {row['ms']:.4f} ms (clocked copy "
                  f"{row['clocked_ms']:.4f})"
                  + (f", all-read variant {row['allread_ms']:.4f} "
                     f"({row['allread_ms'] / row['ms']:.3f}x; error "
                     f"{row['allread_err']:.2e}, bar "
                     f"{row['allread_bar']:.2e})" if dt == "bfloat16"
                     else "")
                  + f" | cycles a block per tile: loop "
                  f"{row['loop_cycles_per_tile']:.0f}; " + ", ".join(
                      f"{p} {n:.0f}"
                      for p, n in row["cycles_per_tile"].items())
                  + f" ({row['blocks']} blocks)", flush=True)
            del q, k, v
    fields = device_fields("cuda")
    print(f"{fields['device']}, {fields['power_limit_w']} W")
    print(json.dumps({"rows": rows, **fields}))


if __name__ == "__main__":
    main()
