"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints; any failure raises and exits non-zero):
 1. the card (nvidia-smi name and power limit), torch and CUDA versions;
 2. build the CUDA kernels from lut_ldpc_torch/csrc/;
 3. each kernel against its plain-torch twin on the card at the headline
    shapes (N=10000 (3,6) QC code, Z=1000, B=8192), in the int16 and the
    float32 spec: values, bits, syndrome and unanimity must be equal;
 4. the headline decode through make_staged_decoder (a HybridLUTDecoder
    with a 32-iteration int16 prefix) at 2 dB, with launch counts, checked
    against the twin path on the card and the scalar golden model;
 5. a 1.5 dB batch that leaves frames undecided past the prefix, so the
    table tail runs on the card, checked the same way;
 6. the headline throughput (decoded information Mbit/s).
Then a JSON line of per-kernel results and, last, the device line.
"""

import json
import subprocess
import sys
import time


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_vs_twin(dec, it, seed, B):
    """CN then VN kernel against its twin on one (rows, B) input; returns
    per-kernel (max_abs_err, kernel ms, twin ms)."""
    import numpy as np
    import torch

    from lut_ldpc_torch.decoder import qc_kernels as qk
    from lut_ldpc_torch.decoder.hybrid import root_levels

    tab, prm, spec = dec.tables, dec.params, dec.spec
    dev = dec.device
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(root_levels(spec, it), device=dev)
    m_vn = table[torch.as_tensor(rng.integers(0, len(table), (tab.rows_vn, B)), device=dev)]
    cha_t = torch.as_tensor(np.asarray(spec.leaf_cha), device=dev).to(m_vn.dtype)
    cha = cha_t[torch.as_tensor(rng.integers(0, len(cha_t), (tab.nvar_pad, B)), device=dev)]
    real_cn, real_vn, nodes = tab.cn_real, tab.vn_real, tab.node_real

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    out = {}
    m_cn_k, synd_k = qk.cn_qc_pass(m_vn, tab)
    m_cn_t, synd_t = qk.cn_qc_pass_ref(m_vn, tab)
    torch.cuda.synchronize()
    e = err(m_cn_k[real_cn], m_cn_t[real_cn])
    if e != 0 or not torch.equal(synd_k, synd_t):
        raise AssertionError(f"cn_qc_pass disagrees with its twin (max err {e})")
    out["cn_qc_pass"] = (e, cuda_ms(lambda: qk.cn_qc_pass(m_vn, tab), 20),
                         cuda_ms(lambda: qk.cn_qc_pass_ref(m_vn, tab), 3))
    m_vn_k, bits_k, unan_k = qk.vn_qc_pass(m_cn_t, cha, it, prm, tab)
    m_vn_t, bits_t, unan_t = qk.vn_qc_pass_ref(m_cn_t, cha, it, prm, tab)
    torch.cuda.synchronize()
    e = err(m_vn_k[real_vn], m_vn_t[real_vn])
    if (e != 0 or not torch.equal(bits_k[nodes], bits_t[nodes])
            or not torch.equal(unan_k, unan_t)):
        raise AssertionError(f"vn_qc_pass disagrees with its twin (max err {e})")
    out["vn_qc_pass"] = (e, cuda_ms(lambda: qk.vn_qc_pass(m_cn_t, cha, it, prm, tab), 20),
                         cuda_ms(lambda: qk.vn_qc_pass_ref(m_cn_t, cha, it, prm, tab), 3))
    log(f"#   synd true {int(synd_k.sum())}/{B}, unan true {int(unan_k.sum())}/{B}")
    return out


def check_golden(codec, lc, lm, out, frames):
    import numpy as np

    bits, _, iters = (o.cpu().numpy() for o in out)
    for f in frames:
        t0 = time.perf_counter()
        b_ref, it_ref = codec.decode_ref(lc[f], lm[f])
        itr = it_ref if it_ref > 0 else codec.max_iters
        if not np.array_equal(np.asarray(b_ref), bits[f]) or itr != iters[f]:
            raise AssertionError(f"frame {f} differs from decode_ref")
        log(f"#   frame {f}: decode_ref agrees (iters {itr}, "
            f"{time.perf_counter() - t0:.1f}s)")


def same(a, b, what):
    import torch

    for x, y, name in zip(a, b, ("bits", "ok", "iters")):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differ")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"# phase 1: card {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    import numpy as np

    from lut_ldpc_torch import bench
    from lut_ldpc_torch._ref import build_arith_prefix_spec
    from lut_ldpc_torch.decoder import (ArithLUTDecoder, HybridLUTDecoder,
                                        make_staged_decoder)
    from lut_ldpc_torch.decoder import qc_kernels as qk

    dev = torch.device("cuda")
    _, secs = qk.build_kernels(force=True)
    log(f"# phase 2: built {qk.KERNEL_SOURCE} in {secs:.1f}s")

    t0 = time.perf_counter()
    codec = bench.build_codec()
    log(f"# codec designed in {time.perf_counter() - t0:.1f}s (N={codec.nvar}, "
        f"k={codec.k}, {codec.max_iters} iterations)")

    B = bench.BATCH
    results = {}
    for dt in (np.int16, np.float32):
        spec = build_arith_prefix_spec(codec, dtype=dt)
        dec = ArithLUTDecoder(codec, dev, spec=spec)
        it = spec.num_iters // 2
        res = kernel_vs_twin(dec, it, seed=1, B=B)
        for name, (e, ms, plain) in res.items():
            log(f"# phase 3: {name} {np.dtype(dt).name} it={it}: equal to twin; "
                f"kernel {ms:.4f} ms, twin {plain:.3f} ms")
            if dt == np.int16:
                results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain)
            else:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], e)

    lc, lm = bench.channel_labels(codec, B, 2.0)
    lc_d, lm_d = torch.as_tensor(lc, device=dev), torch.as_tensor(lm, device=dev)
    dec = make_staged_decoder(codec, dev)
    if not isinstance(dec, HybridLUTDecoder) or dec.S != 32:
        raise AssertionError(f"expected HybridLUTDecoder with S=32, got {type(dec).__name__}")
    qk.reset_launches()
    out = dec(lc_d, lm_d)
    torch.cuda.synchronize()
    launches = dict(qk.LAUNCHES)
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    bits, ok, iters = out
    if bits.shape != (B, codec.nvar) or ok.shape != (B,) or iters.shape != (B,):
        raise AssertionError("unexpected output shapes")
    log(f"# phase 4: {type(dec).__name__} S={dec.S}: launches {launches}, "
        f"ok {float(ok.float().mean()):.6f}, mean iters {float(iters.float().mean()):.4f}, "
        f"tail runs {dec.tail_runs}")
    twin = HybridLUTDecoder(codec, dev, kernels=False)
    same(out, twin(lc_d, lm_d), "2 dB kernel path vs twin path")
    log("#   twin path on the card: identical bits, ok, iters")
    check_golden(codec, lc, lm, out, [0, int(torch.argmax(iters).item())])

    lc15, lm15 = bench.channel_labels(codec, B, 1.5, seed=1)
    runs = dec.tail_runs
    out15 = dec(torch.as_tensor(lc15, device=dev), torch.as_tensor(lm15, device=dev))
    it15 = out15[2].cpu().numpy()
    late = np.nonzero(it15 >= dec.S)[0]
    if dec.tail_runs != runs + 1 or late.size == 0:
        raise AssertionError("the 1.5 dB batch did not reach the table tail")
    same(out15, twin(torch.as_tensor(lc15, device=dev), torch.as_tensor(lm15, device=dev)),
         "1.5 dB kernel path vs twin path")
    conv_late = late[it15[late] < codec.max_iters]
    pick = int(conv_late[0]) if conv_late.size else int(late[0])
    log(f"# phase 5: 1.5 dB: {late.size} frames past iteration {dec.S}, ok "
        f"{float(out15[1].float().mean()):.6f}; twin path identical")
    check_golden(codec, lc15, lm15, out15, [pick])

    dt_s, out = bench.time_decode(dec, lc_d, lm_d, bench.REPS)
    mbits = B * codec.k / dt_s / 1e6
    log(f"# phase 6: headline {mbits:.3f} Mbit/s ({dt_s * 1e3:.3f} ms per {B} frames, "
        f"mean iters {float(out[2].float().mean()):.4f}, ok {float(out[1].float().mean()):.6f}) "
        f"on {smi}")

    src = "lut_ldpc_torch/csrc/qc_kernels.cu"
    replaces = {"cn_qc_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:549",
                "vn_qc_pass": "lut_ldpc_tpu/decoder/qc_kernels.py:873"}
    print(json.dumps({"kernels": [
        dict(name=n, route="cuda", source=src, replaces=replaces[n],
             launches=launches[n], **results[n]) for n in ("cn_qc_pass", "vn_qc_pass")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
