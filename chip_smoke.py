"""Smoke run of fastqueeze_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card: name and power limit;
  2. build: the four CUDA kernels from fastqueeze_tpu_torch/csrc;
  3. kernels: each against its plain PyTorch version on the card at the
     main path's shapes (L = 4096 lanes, T = 6144 waves: a 50 MB block of
     100 bp reads), for the order-10 seq table and two qual tables (the
     fqz formula, 2^16 rows x 48; a hashed rank chain k=4, 2^16 hash
     rows, 3 pos bits); bit-equal, with times (CUDA events, warmed);
  4. end to end: a seeded ~72 MB FASTQ (300,000 x 100 bp reads sampled
     from a random 100 Mbp genome) through the CLI's compress and
     decompress, compared byte for byte; every kernel must have launched
     and the native host coder must not have run;
  5. oracle: the same input compressed with FASTQUEEZE_FROZEN_EXEC=host
     (the native coder, bit-identical to the JAX package's device path)
     must give the same archive, and it decodes on the card.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernel table as JSON.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
L_MAIN, T_MAIN, READ_LEN = 4096, 6144, 100


def card() -> str:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA card visible (torch.cuda.is_available() "
                 "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    return smi


def build():
    """The CUDA kernels, and the native host library (make -C native) the
    pipeline's host stages use, so phase 4 times no set-up."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.ops import kernels
    t0 = time.time()
    info = kernels.build()
    print(f"build: {time.time() - t0:.1f} s wall ({info['path']})")
    for line in str(info["ptxas"]).splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  " + line.strip())
    t0 = time.time()
    if native.get_lib() is None:
        raise RuntimeError("native host library unavailable (make -C native)")
    print(f"native host library: {time.time() - t0:.1f} s wall")


def _time_ms(fn, reps: int) -> float:
    """Mean ms of `reps` calls; the caller has already run `fn` once (the
    comparison call), which is the warm-up."""
    import torch
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def check_kernels():
    """Each kernel vs its plain version, same inputs on the card."""
    import torch
    from fastqueeze_tpu_torch.models.base import QualModel, SeqModel
    from fastqueeze_tpu_torch.ops import engine, kernels
    from fastqueeze_tpu_torch.ops.lanes import make_layout, to_grid
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED)
    R = (T_MAIN * 7 // 8 // READ_LEN) * L_MAIN   # 217,088 reads -> T 6144
    counts = np.full(R, READ_LEN, np.int64)
    cg = torch.from_numpy(engine._counts_grid(counts, L_MAIN)).to(dev)
    models = {
        "seq_order10": SeqModel(alphabet=4, init=3, inc=1, cap=253,
                                order=10),
        "qual_fqz_A48": QualModel(alphabet=48, qlevel=2),
        "qual_k4_hash16_pos3": QualModel(alphabet=48, k=4, ctx_base=40,
                                         hash_bits=16, pos_bits=3),
    }
    rows = {}
    for tag, m in models.items():
        table = rng.integers(1, 254 if m.alphabet == 4 else 400,
                             (m.n_ctx, m.alphabet)).astype(np.int32)
        syms = rng.integers(0, m.alphabet, R * READ_LEN).astype(np.uint8)
        lay = make_layout(counts, L_MAIN)
        assert (lay.T, lay.L) == (T_MAIN, L_MAIN), (lay.T, lay.L)
        g = torch.from_numpy(to_grid(lay, syms)).to(dev)
        c = torch.from_numpy(table).to(dev)

        r = {}
        k1 = kernels.quant_pack(c)
        p1 = kernels.quant_pack_plain(c)
        r["quant_pack"] = (max(_max_err(k1[0], p1[0]), _max_err(k1[1], p1[1])),
                           _time_ms(lambda: kernels.quant_pack(c), 5),
                           _time_ms(lambda: kernels.quant_pack_plain(c), 1))
        cum, packed = k1
        k2 = kernels.frozen_encode_lanes(g, cg, packed, m)
        p2 = kernels.frozen_encode_lanes_plain(g, cg, packed, m)
        r["frozen_encode_lanes"] = (
            max(_max_err(a, b) for a, b in zip(k2, p2)),
            _time_ms(lambda: kernels.frozen_encode_lanes(g, cg, packed, m), 3),
            _time_ms(lambda: kernels.frozen_encode_lanes_plain(g, cg, packed,
                                                               m), 1))
        words, emit, states = k2
        k3 = kernels.compact_words(words, emit)
        p3 = kernels.compact_words_plain(words, emit)
        n = int(p3[1].item())
        r["compact_words"] = (
            max(_max_err(k3[1], p3[1]), _max_err(k3[0][:n], p3[0][:n])),
            _time_ms(lambda: kernels.compact_words(words, emit), 5),
            _time_ms(lambda: kernels.compact_words_plain(words, emit), 1))
        W = 1024
        while W < n + 8:
            W <<= 1
        wpad = torch.zeros(W, dtype=torch.int16, device=dev)
        wpad[:n] = k3[0][:n]
        k4 = kernels.frozen_decode(states, wpad, cg, T_MAIN, cum, m)
        p4 = kernels.frozen_decode_plain(states, wpad, cg, T_MAIN, cum, m)
        r["frozen_decode"] = (
            _max_err(k4, p4),
            _time_ms(lambda: kernels.frozen_decode(states, wpad, cg, T_MAIN,
                                                   cum, m), 2),
            _time_ms(lambda: kernels.frozen_decode_plain(states, wpad, cg,
                                                         T_MAIN, cum, m), 1))
        if not torch.equal(k4.cpu(), torch.from_numpy(to_grid(lay, syms))):
            raise AssertionError(f"{tag}: decode does not invert encode")
        for name, (err, ms, pms) in r.items():
            print(f"  {tag:22s} {name:20s} max_abs_err {err}  kernel "
                  f"{ms:10.3f} ms  plain {pms:10.3f} ms")
            if err:
                raise AssertionError(f"{tag} {name}: kernel differs from "
                                     f"its plain version ({err})")
        rows[tag] = r
    return rows


def _genome_fastq(path: str) -> int:
    """300,000 x 100 bp reads from a seeded random 100 Mbp genome, ~1%
    substitutions, ~0.1% N, qualities from a seeded first-order Markov
    chain over 40 Phred values; SRA-style IDs.  Returns the read count."""
    rng = np.random.default_rng(SEED)
    R, G = 300_000, 100_000_000
    genome = rng.integers(0, 4, G, dtype=np.uint8)
    starts = rng.integers(0, G - READ_LEN, R)
    codes = genome[starts[:, None] + np.arange(READ_LEN)]
    sub = rng.random(codes.shape) < 0.01
    codes[sub] = (codes[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    seq = np.frombuffer(b"ACGT", np.uint8)[codes]
    seq[rng.random(seq.shape) < 0.001] = ord("N")
    # first-order Markov qualities: states 0..39 = Phred 2..41, a band
    # around the current value, drifting down along the read
    S = 40
    P = np.exp(-np.abs(np.arange(S)[None, :] - np.arange(S)[:, None]
                       + 0.6) / 1.5)
    P[:, -1] += 0.02
    P /= P.sum(axis=1, keepdims=True)
    flat = (np.cumsum(P, axis=1) + np.arange(S)[:, None]).ravel()
    st = np.minimum(rng.geometric(0.08, R), S) - 1
    st = S - 1 - st
    q = np.empty((R, READ_LEN), np.uint8)
    for i in range(READ_LEN):
        q[:, i] = st
        u = rng.random(R)
        st = np.minimum(np.searchsorted(flat, st + u, side="right") - st * S,
                        S - 1)
    qual = (q + 2 + 33).astype(np.uint8)
    with open(path, "wb") as fh:
        for r in range(R):
            fh.write(b"@SRR0000001.%d %d length=100\n" % (r + 1, r + 1)
                     + seq[r].tobytes() + b"\n+\n" + qual[r].tobytes()
                     + b"\n")
    return R


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def end_to_end(tmp: str):
    from fastqueeze_tpu_torch import cli
    from fastqueeze_tpu_torch.ops import host_frozen, kernels
    fq = os.path.join(tmp, "in.fq")
    t0 = time.time()
    n_reads = _genome_fastq(fq)
    size = os.path.getsize(fq)
    print(f"input: {n_reads} reads, {size} bytes ({time.time() - t0:.1f} s "
          f"to generate)")
    arc = os.path.join(tmp, "out.fqz")
    back = os.path.join(tmp, "back")

    kernels.reset_launch_counts()
    for k in host_frozen.NATIVE_CALLS:
        host_frozen.NATIVE_CALLS[k] = 0
    t0 = time.time()
    if cli.main(["-c", "-1", fq, "-o", arc, "-f"]) != 0:
        raise RuntimeError("compress failed")
    t_enc = time.time() - t0
    t0 = time.time()
    if cli.main(["-d", arc, "-o", back, "-f"]) != 0:
        raise RuntimeError("decompress failed")
    t_dec = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    native_calls = dict(host_frozen.NATIVE_CALLS)
    if not _same_file(fq, back + ".fastq"):
        raise AssertionError("round trip differs from the input")
    arc_size = os.path.getsize(arc)
    print(f"end to end: encode {t_enc:.3f} s = {n_reads / t_enc:.0f} reads/s,"
          f" decode {t_dec:.3f} s = {n_reads / t_dec:.0f} reads/s, "
          f"ratio {size / arc_size:.4f} ({arc_size} bytes); byte-exact")
    print(f"kernel launches in the main path: {launches}; native frozen "
          f"coder calls: {native_calls}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched: {launches}")
    if sum(native_calls.values()):
        raise AssertionError(f"native coder ran on the card path: "
                             f"{native_calls}")

    # oracle: the native host coder (FASTQUEEZE_FROZEN_EXEC is execution
    # routing only; frozen_exec would change PARAM)
    arc_h = os.path.join(tmp, "host.fqz")
    os.environ["FASTQUEEZE_FROZEN_EXEC"] = "host"
    try:
        if cli.main(["-c", "-1", fq, "-o", arc_h, "-f"]) != 0:
            raise RuntimeError("host-routed compress failed")
    finally:
        del os.environ["FASTQUEEZE_FROZEN_EXEC"]
    if not _same_file(arc, arc_h):
        raise AssertionError("card archive != native-host archive")
    if cli.main(["-d", arc_h, "-o", back + "_h", "-f"]) != 0:
        raise RuntimeError("decode of the host archive failed")
    if not _same_file(fq, back + "_h.fastq"):
        raise AssertionError("host archive decoded on the card differs")
    print("oracle: archive equals the native-host archive byte for byte; "
          "decodes on the card")
    return launches


_REPLACES = {
    "quant_pack": ("fastqueeze_tpu_torch/csrc/quant_pack.cu",
                   "fastqueeze_tpu/ops/engine.py:544"),
    "frozen_encode_lanes": ("fastqueeze_tpu_torch/csrc/frozen_encode.cu",
                            "fastqueeze_tpu/ops/engine.py:832"),
    "compact_words": ("fastqueeze_tpu_torch/csrc/compact_words.cu",
                      "fastqueeze_tpu/ops/engine.py:509"),
    "frozen_decode": ("fastqueeze_tpu_torch/csrc/frozen_decode.cu",
                      "fastqueeze_tpu/ops/engine.py:683"),
}


def main() -> int:
    card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    build()
    rows = check_kernels()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = end_to_end(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seq = rows["seq_order10"]
    table = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
              "launches": launches[k],
              "max_abs_err": max(r[k][0] for r in rows.values()),
              "ms": seq[k][1], "plain_ms": seq[k][2]}
             for k, (src, rep) in _REPLACES.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
