"""Markdown summary tables from the port's committed records: the port's
``scripts/eval_summary.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.eval_summary

Reads ``data/torch/benchmarks/**`` only (never the JAX records) and prints
the kernel sweep (GPU, and the CPU baseline beside it), the closed-loop
track and GPS L5 dual sweeps, the accumulator accuracy, acquisition and the
reduction and replica micro-benchmarks, so every number regenerates from
committed records with one command. Each table names the card and its power
limit as the records give them.
"""

from __future__ import annotations

import json
import statistics

from . import BENCHMARKS


def _load(subdir):
    rows = []
    for p in sorted((BENCHMARKS / subdir).glob("*.json")):
        d = json.loads(p.read_text())
        if "error" not in d:
            rows.append(d)
    return rows


def _us(x):
    return f"{x * 1e6:.0f}"


def _iqr(row):
    """Interquartile range of the raw trial times (seconds), or None."""
    ts = sorted(row.get("times") or [])
    if len(ts) < 4:
        return None
    q = statistics.quantiles(ts, n=4)
    return q[2] - q[0]


def _cell_us(row):
    """'median±iqr' in µs; a trailing '*' flags noise-dominated cells (IQR >=
    median)."""
    if row is None:
        return "—"
    med = row["Median"]
    iqr = _iqr(row)
    if iqr is None:
        return _us(med)
    flag = "\\*" if iqr >= med and med > 0 else ""
    return f"{_us(med)}±{_us(iqr)}{flag}"


def _ms(row):
    iqr = _iqr(row)
    ms = f"{row['Median'] * 1e3:.3f}"
    if iqr is not None:
        ms += f"±{iqr * 1e3:.3f}"
        if row["Median"] > 0 and iqr >= row["Median"]:
            ms += "\\*"
    return ms


def _cards(rows) -> str:
    cards = sorted({f"{r['gpu_name']}, {r['power_limit']}" for r in rows if r.get("gpu_name")})
    return "; ".join(cards) if cards else "CPU"


def kernel_table(gnss, processor, num_ants, num_correlators):
    rows = [r for r in _load("kernel")
            if r["GNSS"] == gnss and r["processor"] == processor
            and r["num_ants"] == num_ants and r["num_correlators"] == num_correlators]
    if not rows:
        return
    ns = sorted({r["num_samples"] for r in rows})
    algos = sorted({r["algorithm"] for r in rows})
    print(f"\n### {gnss} {processor} M={num_ants} L={num_correlators} (median±IQR µs per "
          f"1 ms block; \\* = IQR ≥ median, noise-dominated; {_cards(rows)})\n")
    print("| algorithm | " + " | ".join(f"N={n}" for n in ns) + " |")
    print("|---" * (len(ns) + 1) + "|")
    for a in algos:
        cells = []
        for n in ns:
            m = [r for r in rows if r["algorithm"] == a and r["num_samples"] == n]
            cells.append(_cell_us(m[0] if m else None))
        print(f"| `{a}` | " + " | ".join(cells) + " |")


def track_table():
    rows = [r for r in _load("track") if "num_channels" in r and "bank_channels" not in r]
    if not rows:
        return
    print(f"\n### Closed-loop track sweep (median ms/block; rt chans; {_cards(rows)})\n")
    print("| GNSS | algorithm | fs MHz | K | M | L | ms/block | rt chans |")
    print("|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r.get("GNSS", ""), r["algorithm"], -r["num_samples"],
                                         r.get("num_ants", 1), r.get("num_correlators", 3),
                                         -r["num_channels"])):
        print(f"| {r.get('GNSS', '—')} | `{r['algorithm']}` | {r['num_samples'] / 1e3:.3f} "
              f"| {r['num_channels']} | {r.get('num_ants', 1)} "
              f"| {r.get('num_correlators', 3)} | {_ms(r)} "
              f"| {min(r['realtime_channels'], r['num_channels'] * 1000):.0f} |")


def dual_track_table():
    rows = [r for r in _load("track") if r.get("bank_channels") and r.get("GNSS") == "GPSL5"]
    if not rows:
        return
    print("\n### GPS L5 dual-component closed loop (K dual channels = 2K bank channels, NH "
          f"wipe-off + pilot atan2; median±IQR ms/block; {_cards(rows)})\n")
    print("| fs MHz | K dual | bank chans | ms/block | rt dual chans |")
    print("|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["num_samples"], r["num_channels"])):
        print(f"| {r['num_samples'] / 1e3:.3f} | {r['num_channels']} | {r['bank_channels']} "
              f"| {_ms(r)} | {min(r['realtime_channels'], r['num_channels'] * 1000):.0f} |")


def accuracy_table():
    path = BENCHMARKS / "accumulator_accuracy.json"
    if not path.exists():
        return
    d = json.loads(path.read_text())
    cells = d["cells"]
    algos = []
    for c in cells:
        for a in c["algorithms"]:
            if a not in algos:
                algos.append(a)
    config = d["config"]
    print("\n### Accumulator SNR vs float64 oracle (dB; noisy multi-satellite front end, "
          f"K={config['K']}, backend={config.get('backend')}, "
          f"{config.get('gpu_name')}, {config.get('power_limit')})\n")
    header = [f"{c['GNSS'][3:]} N={c['num_samples']}" for c in cells]
    print("| algorithm | " + " | ".join(header) + " |")
    print("|---" * (len(cells) + 1) + "|")
    for a in algos:
        row = []
        for c in cells:
            e = c["algorithms"].get(a)
            row.append(f"{e['snr_db']:.0f}" if e and "snr_db" in e else "—")
        print(f"| `{a}` | " + " | ".join(row) + " |")
    extras = [e["max_rel_vs_f32"] for c in cells for e in c["algorithms"].values()
              if "max_rel_vs_f32" in e]
    if extras:
        print(f"\nbf16 z-planes vs the same kernel in f32 (max rel over all cells): "
              f"{max(extras):.1e}")


def acquire_table():
    rows = _load("acquire") if (BENCHMARKS / "acquire").exists() else []
    if not rows:
        return
    print("\n### PCPS acquisition (`torch.fft`: cuFFT on the card, the host's FFT on the CPU; "
          f"median±IQR ms per full acquisition call; {_cards(rows)})\n")
    print("| proc | GNSS | N | K PRNs | rounds | Doppler bins | ms/call | ms/PRN·round |")
    print("|---|---|---|---|---|---|---|---|")
    for r in sorted(rows, key=lambda r: (r["processor"], r["GNSS"], r["num_samples"],
                                         r["num_prns"], r["rounds"])):
        per = r["Median"] * 1e3 / (r["num_prns"] * r["rounds"])
        print(f"| {r['processor']} | {r['GNSS']} | {r['num_samples']} | {r['num_prns']} "
              f"| {r['rounds']} | {r['num_bins']} | {_ms(r)} | {per:.4f} |")


def micro_tables():
    for kind, title, algos in (
            ("reduction", "Reduction fusion degrees", ("pure", "cplx", "cplx_multi")),
            ("replica", "Replica generation, exact vs quantized NCO", ("exact", "quantized"))):
        rows = _load(kind)
        if not rows:
            continue
        print(f"\n### {title} (median µs; {_cards(rows)})\n")
        ns = sorted({r["num_samples"] for r in rows})
        print("| algorithm | " + " | ".join(f"N={n}" for n in ns) + " |")
        print("|---" * (len(ns) + 1) + "|")
        for a in algos:
            cells = [_us(next((r["Median"] for r in rows
                               if r["algorithm"] == a and r["num_samples"] == n), float("nan")))
                     for n in ns]
            print(f"| `{a}` | " + " | ".join(cells) + " |")


def cpu_vs_gpu(gnss="GPSL1"):
    rows = [r for r in _load("kernel") if r["GNSS"] == gnss and r["algorithm"] == "fused_xla"
            and r["num_ants"] == 1 and r["num_correlators"] == 3]
    ns = sorted({r["num_samples"] for r in rows})
    if not ns:
        return
    print(f"\n### {gnss} fused_xla: host CPU vs the card (median µs, M=1 L=3; "
          f"{_cards(rows)})\n")
    print("| processor | " + " | ".join(f"N={n}" for n in ns) + " |")
    print("|---" * (len(ns) + 1) + "|")
    for proc in ("CPU", "GPU"):
        cells = [_us(next((r["Median"] for r in rows
                           if r["processor"] == proc and r["num_samples"] == n), float("nan")))
                 for n in ns]
        print(f"| {proc} | " + " | ".join(cells) + " |")


def main() -> int:
    for m, l in ((1, 3), (4, 3), (4, 7)):
        kernel_table("GPSL1", "GPU", m, l)
    kernel_table("GPSL5", "GPU", 4, 7)
    cpu_vs_gpu()
    track_table()
    dual_track_table()
    accuracy_table()
    acquire_table()
    micro_tables()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
