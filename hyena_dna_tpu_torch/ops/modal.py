"""Modal (SSM) distillation of Hyena's implicit long filters (a copy of
`hyena_dna_tpu/ops/modal.py`, numpy only, run on the host).

Hyena filters are exponentially-modulated sinusoid mixtures by construction
(HyenaFilter: sin-MLP x exponential decay), i.e. near-exact sums of complex
exponentials

    k[t] ~= Re( sum_p  c_p * lam_p^t ),   |lam_p| <= 1,

so the long conv distills into a P-mode linear state-space recurrence

    s_p[t] = lam_p * s_p[t-1] + v[t],     y[t] = Re(sum_p c_p s_p[t]) + bias*v[t]

with O(d*P) work per token (the "Laughing Hyena" distillation,
arXiv 2310.18780, with a matrix-pencil fit). Poles are estimated per
channel by the matrix-pencil method (Hankel SVD + shifted eigenproblem),
amplitudes by complex least squares on the full filter.

The fit runs once per checkpoint at serving-setup time
(`recurrent.py::distill`). `python -m hyena_dna_tpu_torch.ops.modal
N_MODES` is one fit worker: a (C, L) float64 `.npy` bank on stdin, the
`.npz` of its (lam, c) on stdout.
"""

from __future__ import annotations

import io
import sys
from typing import Tuple

import numpy as np


def fit_modal_channel(k: np.ndarray, n_modes: int,
                      pencil: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Fit one length-L real filter with n_modes complex exponentials.

    Returns (lam, c) complex64 arrays of shape (n_modes,). Reconstruction:
    k[t] ~= Re(sum_p c_p lam_p^t).
    """
    k = np.asarray(k, np.float64)
    L = k.shape[0]
    P = min(n_modes, max(2, L // 4))
    M = pencil if pencil is not None else min(max(4 * P, 64), L // 2)
    # Hankel: Y[i, j] = k[i + j], i < L - M, j <= M
    rows = L - M
    Y = np.lib.stride_tricks.sliding_window_view(k, M + 1)[:rows]
    U, S, Vh = np.linalg.svd(Y, full_matrices=False)
    r = min(P, int((S > S[0] * 1e-10).sum()))
    V = Vh.conj().T[:, :r]  # (M+1, r)
    V0, V1 = V[:-1], V[1:]
    A = np.linalg.pinv(V0) @ V1  # shift operator in the signal subspace
    lam = np.linalg.eigvals(A)
    lam = lam[np.abs(lam) > 1e-8]
    # stability clip: generation must not diverge
    mag = np.abs(lam)
    lam = np.where(mag > 1.0, lam / mag, lam)

    # amplitudes: complex least squares on the Vandermonde of the poles.
    # k real => using Re(V c) with unconstrained complex c doubles the real
    # DOF exactly like fitting conjugate pairs.
    t = np.arange(L)
    with np.errstate(divide="ignore"):
        logl = np.log(np.where(lam == 0, 1e-300, lam))
    Vand = np.exp(t[:, None] * logl[None, :])  # (L, r)
    # solve min || [Re V, -Im V] [Re c; Im c] - k ||
    A2 = np.concatenate([Vand.real, -Vand.imag], axis=1)
    sol, *_ = np.linalg.lstsq(A2, k, rcond=None)
    c = sol[: lam.size] + 1j * sol[lam.size:]

    out_l = np.zeros(n_modes, np.complex64)
    out_c = np.zeros(n_modes, np.complex64)
    out_l[: lam.size] = lam.astype(np.complex64)
    out_c[: lam.size] = c.astype(np.complex64)
    return out_l, out_c


def fit_modal_filters(k: np.ndarray, n_modes: int = 32,
                      fit_len: int | None = None):
    """Fit a (C, L) filter bank. Returns (lam, c): (C, n_modes) complex64.

    fit_len caps the pencil/LSQ length (long filters decay; 8k samples
    pin the visible modes and the LSQ tail weight).
    """
    k = np.asarray(k, np.float64)
    C, L = k.shape
    if fit_len is not None and L > fit_len:
        k = k[:, :fit_len]
    lam = np.zeros((C, n_modes), np.complex64)
    c = np.zeros((C, n_modes), np.complex64)
    for ch in range(C):
        lam[ch], c[ch] = fit_modal_channel(k[ch], n_modes)
    return lam, c


def modal_reconstruction(lam: np.ndarray, c: np.ndarray, L: int) -> np.ndarray:
    """Re-materialize (C, L) filters from modal form (for fit validation)."""
    t = np.arange(L)
    safe = np.where(lam == 0, 1.0, lam)  # unused (c==0) pad modes
    with np.errstate(divide="ignore"):
        logl = np.log(safe.astype(np.complex128))
    basis = np.exp(logl[..., None] * t)  # (C, P, L)
    basis = np.where((lam == 0)[..., None], 0.0, basis)
    return np.real(np.einsum("cp,cpl->cl", c, basis)).astype(np.float32)


if __name__ == "__main__":
    bank = np.load(io.BytesIO(sys.stdin.buffer.read()), allow_pickle=False)
    lam, c = fit_modal_filters(bank, int(sys.argv[1]))
    out = io.BytesIO()
    np.savez(out, lam=lam, c=c)
    sys.stdout.buffer.write(out.getvalue())
