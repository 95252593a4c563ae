"""Linear-Gaussian Kalman filtering and smoothing with EM-fit noise covariances.

Port of ``sleap_nn_tpu/tracking/kalman.py``: the numpy implementation of
the slice of the ``pykalman.KalmanFilter`` API that the Kalman tracker
calls, from the Shumway-Stoffer (1982) equations, all in float64.

- ``KalmanFilter(transition_matrices=, observation_matrices=,
  initial_state_mean=)``
- ``.em(X, n_iter=, em_vars=[...])`` with ``X`` a ``(T, d_obs)`` masked array;
  learns only the covariances named in ``em_vars`` (structural matrices and
  the initial mean stay fixed).
- ``.filter(X) -> (means, covariances)``
- ``.filter_update(mean, cov, observation=...)`` — one predict(+correct)
  step; ``observation=np.ma.masked`` (or any observation with a masked/NaN
  entry) is treated as fully missing — pykalman's any-masked-skips-the-update
  rule — so the filter coasts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["KalmanFilter"]


def _sym(P: np.ndarray) -> np.ndarray:
    """Numerical hygiene: keep covariances exactly symmetric."""
    return (P + P.T) * 0.5


def _is_missing(observation) -> bool:
    """True when an observation should be skipped (coast-only step).

    pykalman treats a timestep with ANY masked component as fully
    unobserved; NaNs get the same treatment here so plain arrays with
    missing coordinates behave identically to masked ones.
    """
    if observation is None:
        return True
    if observation is np.ma.masked:
        return True
    arr = np.ma.asarray(observation)
    if np.ma.getmaskarray(arr).any():
        return True
    return bool(np.isnan(np.asarray(arr, dtype=float)).any())


class KalmanFilter:
    """Constant-parameter linear-Gaussian state-space model.

    x_{t+1} = A x_t + w,  w ~ N(0, Q)
    z_t     = C x_t + v,  v ~ N(0, R)
    x_0 ~ N(mu_0, Sigma_0)
    """

    def __init__(
        self,
        transition_matrices=None,
        observation_matrices=None,
        transition_covariance=None,
        observation_covariance=None,
        initial_state_mean=None,
        initial_state_covariance=None,
    ):
        A = np.asarray(transition_matrices, dtype=float)
        C = np.asarray(observation_matrices, dtype=float)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"transition_matrices must be square, got {A.shape}")
        if C.ndim != 2 or C.shape[1] != A.shape[0]:
            raise ValueError(
                f"observation_matrices {C.shape} incompatible with state dim "
                f"{A.shape[0]}"
            )
        n, d = A.shape[0], C.shape[0]
        self.transition_matrices = A
        self.observation_matrices = C
        self.transition_covariance = (
            np.eye(n) if transition_covariance is None
            else np.asarray(transition_covariance, dtype=float)
        )
        self.observation_covariance = (
            np.eye(d) if observation_covariance is None
            else np.asarray(observation_covariance, dtype=float)
        )
        self.initial_state_mean = (
            np.zeros(n) if initial_state_mean is None
            else np.asarray(initial_state_mean, dtype=float)
        )
        self.initial_state_covariance = (
            np.eye(n) if initial_state_covariance is None
            else np.asarray(initial_state_covariance, dtype=float)
        )

    @property
    def n_dim_state(self) -> int:
        return self.transition_matrices.shape[0]

    @property
    def n_dim_obs(self) -> int:
        return self.observation_matrices.shape[0]

    # -- observation plumbing ---------------------------------------------------

    def _obs_rows(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """(T, d) float data and (T,) observed-mask from array/masked input."""
        Xm = np.ma.asarray(X)
        data = np.asarray(np.ma.filled(Xm.astype(float), np.nan), dtype=float)
        if data.ndim == 1:
            data = data[None, :]
        missing = np.isnan(data).any(axis=1) | np.ma.getmaskarray(
            Xm.reshape(data.shape)
        ).any(axis=1)
        return data, ~missing

    # -- core recursions ----------------------------------------------------------

    def _correct(self, mean: np.ndarray, cov: np.ndarray, z: np.ndarray):
        C, R = self.observation_matrices, self.observation_covariance
        S = C @ cov @ C.T + R
        # Solve instead of invert: K = P C^T S^-1  ->  S K^T = C P^T.
        K = np.linalg.solve(S, C @ cov.T).T
        mean = mean + K @ (z - C @ mean)
        cov = _sym((np.eye(self.n_dim_state) - K @ C) @ cov)
        return mean, cov, K

    def filter(self, X) -> Tuple[np.ndarray, np.ndarray]:
        """Forward pass; returns filtered means (T, n) and covariances (T, n, n)."""
        (means, covs), _ = self._filter_full(X)
        return means, covs

    def _filter_full(self, X):
        """Forward pass, also returning the predicted (prior) moments per step."""
        data, observed = self._obs_rows(X)
        T = data.shape[0]
        n = self.n_dim_state
        A, Q = self.transition_matrices, self.transition_covariance
        means = np.zeros((T, n))
        covs = np.zeros((T, n, n))
        pred_means = np.zeros((T, n))
        pred_covs = np.zeros((T, n, n))
        mean, cov = self.initial_state_mean, self.initial_state_covariance
        for t in range(T):
            if t > 0:
                mean = A @ means[t - 1]
                cov = _sym(A @ covs[t - 1] @ A.T + Q)
            pred_means[t], pred_covs[t] = mean, cov
            if observed[t]:
                mean, cov, _ = self._correct(mean, cov, data[t])
            means[t], covs[t] = mean, cov
        return (means, covs), (pred_means, pred_covs)

    def filter_update(
        self,
        filtered_state_mean,
        filtered_state_covariance,
        observation=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One predict(+correct) step from a filtered state (pykalman-compatible)."""
        A, Q = self.transition_matrices, self.transition_covariance
        mean = A @ np.asarray(filtered_state_mean, dtype=float)
        cov = _sym(A @ np.asarray(filtered_state_covariance, dtype=float) @ A.T + Q)
        if _is_missing(observation):
            return mean, cov
        z = np.asarray(np.ma.filled(np.ma.asarray(observation), np.nan), dtype=float)
        mean, cov, _ = self._correct(mean, cov, z)
        return mean, cov

    def smooth(self, X) -> Tuple[np.ndarray, np.ndarray]:
        means, covs, _ = self._smooth_full(X)
        return means, covs

    def _smooth_full(self, X):
        """RTS smoother; also returns the smoothing gains J_t (for EM)."""
        (f_means, f_covs), (p_means, p_covs) = self._filter_full(X)
        T, n = f_means.shape
        A = self.transition_matrices
        s_means = f_means.copy()
        s_covs = f_covs.copy()
        gains = np.zeros((max(T - 1, 0), n, n))
        for t in range(T - 2, -1, -1):
            # J_t = P_t A^T (P^pred_{t+1})^-1, via solve on the symmetric prior.
            J = np.linalg.solve(p_covs[t + 1], A @ f_covs[t].T).T
            gains[t] = J
            s_means[t] = f_means[t] + J @ (s_means[t + 1] - p_means[t + 1])
            s_covs[t] = _sym(f_covs[t] + J @ (s_covs[t + 1] - p_covs[t + 1]) @ J.T)
        return s_means, s_covs, gains

    # -- EM -----------------------------------------------------------------------

    _EM_VARS = (
        "transition_covariance",
        "observation_covariance",
        "initial_state_covariance",
        "initial_state_mean",
    )

    def em(self, X, n_iter: int = 10, em_vars: Optional[Sequence[str]] = None):
        """Fit the requested parameters by EM over one observation sequence.

        E-step: RTS smoothing under the current parameters; pairwise smoothed
        covariances via Cov(x_t, x_{t-1} | Z) = P^s_t J_{t-1}^T. M-step:
        closed-form covariance updates (Shumway–Stoffer), restricted to
        ``em_vars``: the Kalman tracker fixes the structural matrices and
        the initial mean and learns only the three covariances.
        """
        if em_vars is None:
            em_vars = ["transition_covariance", "observation_covariance"]
        unknown = set(em_vars) - set(self._EM_VARS)
        if unknown:
            raise ValueError(f"Unknown em_vars: {sorted(unknown)}")
        data, observed = self._obs_rows(X)
        T = data.shape[0]
        A, C = self.transition_matrices, self.observation_matrices
        for _ in range(int(n_iter)):
            s_means, s_covs, gains = self._smooth_full(
                np.ma.masked_invalid(data)
            )
            # Second moments: E[x_t x_t^T] and E[x_t x_{t-1}^T].
            Exx = s_covs + np.einsum("ti,tj->tij", s_means, s_means)
            if T > 1:
                pair = np.einsum("tij,tkj->tik", s_covs[1:], gains) + np.einsum(
                    "ti,tj->tij", s_means[1:], s_means[:-1]
                )  # pair[t] = E[x_{t+1} x_t^T]
            if "transition_covariance" in em_vars and T > 1:
                Qn = np.zeros_like(self.transition_covariance)
                for t in range(T - 1):
                    AE = A @ pair[t].T  # A E[x_t x_{t+1}^T]
                    Qn += Exx[t + 1] - AE - AE.T + A @ Exx[t] @ A.T
                self.transition_covariance = _sym(Qn / (T - 1))
            if "observation_covariance" in em_vars:
                idx = np.where(observed)[0]
                if idx.size:
                    Rn = np.zeros_like(self.observation_covariance)
                    for t in idx:
                        resid = data[t] - C @ s_means[t]
                        Rn += np.outer(resid, resid) + C @ s_covs[t] @ C.T
                    self.observation_covariance = _sym(Rn / idx.size)
            if "initial_state_mean" in em_vars:
                self.initial_state_mean = s_means[0]
            if "initial_state_covariance" in em_vars:
                d0 = s_means[0] - self.initial_state_mean
                self.initial_state_covariance = _sym(
                    s_covs[0] + np.outer(d0, d0)
                )
        return self

    def loglikelihood(self, X) -> float:
        """Innovations-form log p(Z) (for EM-monotonicity tests)."""
        data, observed = self._obs_rows(X)
        C, R = self.observation_matrices, self.observation_covariance
        A, Q = self.transition_matrices, self.transition_covariance
        mean, cov = self.initial_state_mean, self.initial_state_covariance
        ll = 0.0
        for t in range(data.shape[0]):
            if t > 0:
                mean = A @ mean
                cov = _sym(A @ cov @ A.T + Q)
            if observed[t]:
                S = C @ cov @ C.T + R
                resid = data[t] - C @ mean
                sign, logdet = np.linalg.slogdet(S)
                ll += -0.5 * (
                    logdet
                    + resid @ np.linalg.solve(S, resid)
                    + data.shape[1] * np.log(2 * np.pi)
                )
                mean, cov, _ = self._correct(mean, cov, data[t])
        return float(ll)
