"""Closed-loop convergence figure: DLL/PLL/FLL pull-in of a Doppler-offset
synthetic signal. The port's ``scripts/plot_track_convergence.py``.

    python -m gpuacceleratedtracking_tpu_torch.scripts.plot_track_convergence [--figure]

Two scenarios on the golden GPS L1 set-up (N=2500 at 2.5 MHz, PRN 1): a
noiseless 212 Hz hand-over Doppler error, and the same with ~45 dB-Hz AWGN
(seeded `torch.Generator`). One channel is tracked for 1 s through
`tracking.track` on the card (its block body replayed as a CUDA graph). The
Doppler error, code-phase error (chips) and C/N0 estimate per block go to
``data/torch/track_convergence.npz``, and the figure to
``img/torch/track_convergence.png`` where matplotlib is installed
(``--figure`` draws it later from the saved curves, on any host).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import GPSL1, gen_signal, soa
from ..tracking import TrackConfig, init_state, track
from . import DATA, IMG

NUM_MS = 1000
N = 2500
DOPPLER_ERR = 212.0
CURVES = DATA / "track_convergence.npz"
FIGURE = IMG / "track_convergence.png"
SCENARIOS = {"noiseless": (0.0, 0), "~45 dB-Hz AWGN": (2.0, 7)}


def run(noise_std, seed, true_doppler=1500.0, num_ms=NUM_MS, device="cuda") -> dict:
    system = GPSL1()
    fs = N / 1e-3
    code_freq_true = system.code_frequency * (1.0 + true_doppler / system.center_frequency)
    generator = None
    if noise_std > 0:
        generator = torch.Generator(device=device).manual_seed(seed)
    signal, _ = gen_signal(system, 0, true_doppler, N * num_ms, duration=num_ms * 1e-3,
                           code_frequency=code_freq_true, start_carrier_phase=0.3,
                           noise_std=noise_std, generator=generator, device=device)
    sre, sim = soa(signal)
    config = TrackConfig.for_system(system, fs, N)
    state = init_state(0, carrier_doppler=true_doppler + DOPPLER_ERR, device=device)
    codes = torch.as_tensor(system.codes, device=device)
    _, out = track(config, codes, state, sre.reshape(num_ms, N), sim.reshape(num_ms, N))
    b = np.arange(num_ms)
    true_phase = (code_freq_true * 1e-3 * (b + 1)) % system.code_length
    half = system.code_length / 2
    code_err = (out.code_phase.cpu().numpy() - true_phase + half) % system.code_length - half
    return {"dop_err": out.carrier_doppler.cpu().numpy() - true_doppler,
            "code_err": code_err, "cn0": out.cn0_dbhz.cpu().numpy()}


def make_figure(runs: dict, out_path) -> dict:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(next(iter(runs.values()))["dop_err"]))   # ms
    fig, axes = plt.subplots(3, 1, figsize=(7.2, 7.5), sharex=True)
    for label, r in runs.items():
        axes[0].plot(t, r["dop_err"], lw=1, label=label)
        axes[1].plot(t, r["code_err"], lw=1, label=label)
        axes[2].plot(t, r["cn0"], lw=1, label=label)
    axes[0].axhline(0, color="k", lw=0.5)
    axes[0].set_ylabel("Doppler error [Hz]")
    axes[0].set_title(f"Closed-loop pull-in: {DOPPLER_ERR:.0f} Hz handoff error, GPS L1 @ "
                      "2.5 MHz (FLL-assisted PLL + DLL), PyTorch port", fontsize=10)
    axes[1].axhline(0, color="k", lw=0.5)
    axes[1].set_ylabel("code phase error [chips]")
    axes[2].set_ylabel("C/N0 est. [dB-Hz]")
    axes[2].set_xlabel("time [ms]")
    for ax in axes:
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    final = {k: float(abs(r["dop_err"][-50:]).mean()) for k, r in runs.items()}
    axes[0].text(0.99, 0.05,
                 " / ".join(f"{k}: |err| last 50 ms = {v:.2f} Hz" for k, v in final.items()),
                 transform=axes[0].transAxes, ha="right", fontsize=7)
    fig.tight_layout()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return final


def save(runs: dict, path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, labels=np.array(list(runs)),
                        **{f"{i}/{name}": value for i, r in enumerate(runs.values())
                           for name, value in r.items()})


def load(path) -> dict:
    with np.load(path) as data:
        return {str(label): {name: data[f"{i}/{name}"] for name in ("dop_err", "code_err", "cn0")}
                for i, label in enumerate(data["labels"])}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--figure" not in argv:
        runs = {label: run(noise, seed) for label, (noise, seed) in SCENARIOS.items()}
        save(runs, CURVES)
        for label, r in runs.items():
            print(f"  {label}: mean |doppler err| over last 50 ms = "
                  f"{abs(r['dop_err'][-50:]).mean():.3f} Hz")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib is not installed: {FIGURE} not drawn; draw it where it is with "
              "--figure")
        return 0
    make_figure(load(CURVES), FIGURE)
    print(FIGURE)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
