#!/usr/bin/env python3
"""Quick first call on the GPU after a kernel change: build, check, stop.

    python3 chip_probe.py

Builds every CUDA source of the PyTorch port with `nvcc` and prints each
source's `ptxas -v` report, then holds the range-path kernels (G1 and G2
to-affine, G2 add and ladder, Miller loop, final exponentiation, GT
product) against their plain torch versions on a few rows with the edge
cases (infinity, P+P, P-P, scalars 0, 1 and r-1, a (0, 0) Miller leg),
and times three of them once at about a block's rows. It takes about a
minute and a half of command time where `chip_smoke.py` takes six:
the place to find a kernel that does not build or disagrees before the
full smoke run. Needs one NVIDIA GPU; imports nothing of JAX.
"""
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch  # noqa: E402

from fabric_token_sdk_tpu_torch.crypto import hostmath as hm  # noqa: E402
from fabric_token_sdk_tpu_torch.ops import _build, curve as cv, curve2 as cv2  # noqa: E402
from fabric_token_sdk_tpu_torch.ops import pairing as pr, stages as st, tower as tw  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_probe.py needs an NVIDIA GPU")
t0 = time.perf_counter()
try:
    _build.build_all()
finally:
    for src, log in sorted(_build.BUILD_LOG.items()):
        print("=====", src)
        print(log[-6000:])
print("build s", time.perf_counter() - t0, flush=True)
dev = torch.device("cuda")
rng = random.Random(3)
g1 = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(3)] + [None]
g2 = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
bad = []


def chk(name, got, want):
    ok = torch.equal(got.cpu(), want.cpu())
    print(name, "OK" if ok else "MISMATCH", flush=True)
    if not ok:
        bad.append(name)


p = torch.from_numpy(cv.encode_points(g1))
chk("g1_to_affine", st.g1_to_affine_rows(p.to(dev)), st.g1_to_affine_plain(p))
A = [g2[0], g2[0], g2[0], None, None, g2[1]]
B = [g2[0], hm.g2_neg(g2[0]), g2[1], g2[2], None, None]
a = torch.from_numpy(cv2.encode_points(A))
b = torch.from_numpy(cv2.encode_points(B))
chk("g2_add", st.g2_add_rows(a.to(dev), b.to(dev)), st.g2_add_plain(a, b))
chk("g2_to_affine", st.g2_to_affine_rows(a.to(dev)), st.g2_to_affine_plain(a))
pts = g2 + [None]
ks = [0, 1, hm.R - 1, rng.randrange(hm.R)]
pw = torch.from_numpy(cv2.encode_points(pts))
kw = torch.from_numpy(cv.encode_scalars(ks))
chk("g2_mul", st.g2_mul_rows(pw.to(dev), kw.to(dev)), st.g2_mul_plain(pw, kw))
Ps = [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(2)] + [None]
Qs = [hm.g2_mul(hm.G2_GEN, rng.randrange(1, hm.R)) for _ in range(3)]
Pw = torch.from_numpy(pr.encode_g1(Ps))
Qw = torch.from_numpy(pr.encode_g2(Qs))
f = st.miller_rows(Pw.to(dev), Qw.to(dev))
chk("miller", f, st.miller_plain(Pw, Qw))
g = st.final_exp_rows(f)
chk("final_exp", g, st.final_exp_plain(f.cpu()))
print("pairing host", tw.decode_fp12(g.cpu())[:2] == [hm.pairing(x, y) for x, y in zip(Ps[:2], Qs[:2])])
ff = f.reshape(1, 3, 6, 2, 8).contiguous()
chk("gt_product", st.gt_product_rows(ff), st.gt_product_plain(ff.cpu()))


def once(name, fn):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    print(name, (time.perf_counter() - t) * 1e3, "ms", flush=True)


n = 1024
Pn, Qn = Pw[:1].repeat(n, 1, 1).to(dev), Qw[:1].repeat(n, 1, 1, 1).to(dev)
once("miller1024", lambda: st.miller_rows(Pn, Qn))
fn = f[:1].repeat(256, 1, 1, 1).contiguous()
once("final_exp256", lambda: st.final_exp_rows(fn))
pm, km = pw[:1].repeat(512, 1, 1, 1).to(dev), kw[3:4].repeat(512, 1).to(dev)
once("g2_mul512", lambda: st.g2_mul_rows(pm, km))
print("launches", {k.name: k.launches for k in _build.PATH_KERNELS})
sys.exit(1 if bad else 0)
