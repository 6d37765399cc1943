"""Ray storage: SoA arrays over N rays × nt sections.

Behavioral parity with reference ``optrace/tracer/ray_storage.py``
(SURVEY.md §2.6): same public arrays (p_list, s0_list, w_list, n_list,
pol_list, wl_list), source apportioning ∝ power, selective fetch with
direction reconstruction, section/optical length utilities.

Difference: the arrays are filled in one shot from the device trace
output (there is no per-thread slice filling — sharding happens inside the
jitted trace), and positions are f32 (device native) instead of f64.
"""

import numpy as np

from ..utils.base_class import BaseClass
from ..utils.warnings import warning
from ..ops.vector import normalize as _normalize_np


def _normalize_rows(a):
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        return a / n


class RayStorage(BaseClass):

    def __init__(self, **kwargs) -> None:
        self._lock = False
        self.N_list = np.array([], dtype=int)
        self.B_list = np.array([], dtype=int)
        self.no_pol = False
        self.ray_source_list = []
        self.p_list = np.array([])
        self.s0_list = np.array([])
        self.n_list = np.array([])
        self.pol_list = np.array([])
        self.w_list = np.array([])
        self.wl_list = np.array([])
        super().__init__(**kwargs)

    # ------------------------------------------------------------------
    def init(self, ray_source_list: list, N: int, nt: int, no_pol: bool,
             seed: int = 0) -> None:
        """Apportion N rays to the sources ∝ power (reference :35-90).
        Array allocation happens lazily in :meth:`fill`."""
        self._lock = False
        self.no_pol = no_pol
        assert N >= 0 and nt >= 0
        assert len(ray_source_list)

        P_list = np.array([RS.power for RS in ray_source_list])
        P_all = np.sum(P_list)
        self.N_list = (N * P_list / P_all).astype(int)
        dN = N - np.sum(self.N_list)
        if dN > 0:
            rng = np.random.default_rng(seed)
            index_add = rng.choice(self.N_list.shape[0], size=dN, p=P_list / P_all)
            np.add.at(self.N_list, index_add, 1)
        if np.any(self.N_list == 0):
            warning("There are RaySources that have no rays assigned. "
                    "Change the power ratio or raise the overall ray number")
        self.B_list = np.concatenate(([0], np.cumsum(self.N_list))).astype(int)
        self.ray_source_list = ray_source_list

    def fill(self, p, w, pol, n, wl, s0) -> None:
        """Store the device trace output (host numpy copies)."""
        self.p_list = np.asarray(p, dtype=np.float64)
        self.w_list = np.asarray(w, dtype=np.float32)
        self.n_list = np.asarray(n, dtype=np.float64)
        self.wl_list = np.asarray(wl, dtype=np.float32)
        self.s0_list = np.asarray(s0, dtype=np.float64)
        if self.no_pol:
            self.pol_list = np.broadcast_to(np.nan, self.p_list.shape)
        else:
            self.pol_list = np.asarray(pol, dtype=np.float32)

    # ------------------------------------------------------------------
    @staticmethod
    def storage_size(N: int, nt: int, no_pol: bool) -> int:
        """Approximate host RAM of a stored trace in bytes."""
        f32, f64 = 4, 8
        fpol = f32 * N * nt * 3 if not no_pol else f64
        return N * nt * 3 * f64 + N * 3 * f64 + fpol + N * nt * f32 + N * nt * f64 + N * f32

    @staticmethod
    def max_rays_for_size(size: int, nt: int, no_pol: bool) -> int:
        f32, f64 = 4, 8
        if no_pol:
            return (size - f64) // (nt * 3 * f64 + 3 * f64 + nt * f32 + nt * f64 + f32)
        return size // (nt * 3 * f64 + 3 * f64 + f32 * nt * 3 + nt * f32 + nt * f64 + f32)

    @property
    def N(self) -> int:
        return self.p_list.shape[0] if self.N_list.shape[0] and self.p_list.ndim == 3 else 0

    @property
    def Nt(self) -> int:
        return self.p_list.shape[1] if self.N else 0

    # ------------------------------------------------------------------
    def source_sections(self, index: int = None):
        """Ray properties at the source section (p, s, pol, w, wl)."""
        assert self.N, "ray_source_list has no rays stored."
        assert index is None or 0 <= index < len(self.N_list)
        Ns, Ne = self.B_list[index:index + 2] if index is not None else (0, self.N)
        return (self.p_list[Ns:Ne, 0], self.s0_list[Ns:Ne], self.pol_list[Ns:Ne, 0],
                self.w_list[Ns:Ne, 0], self.wl_list[Ns:Ne])

    def source_numbers(self) -> np.ndarray:
        _, _, _, _, _, sn, _ = self.rays_by_mask(ret=[0, 0, 0, 0, 0, 1, 0])
        return sn

    def ray_lengths(self, ch=None, ch2=None) -> np.ndarray:
        """Euclidean section lengths."""
        _, s, _, _, _, _, _ = self.rays_by_mask(ch, ch2, ret=[0, 1, 0, 0, 0, 0, 0], normalize=False)
        return np.linalg.norm(s, axis=s.ndim - 1)

    def optical_lengths(self, ch=None, ch2=None) -> np.ndarray:
        """Optical path lengths l·n per section."""
        _, s, _, _, _, _, n = self.rays_by_mask(ch, ch2, ret=[0, 1, 0, 0, 0, 0, 1], normalize=False)
        l = np.linalg.norm(s, axis=s.ndim - 1)
        return l * n

    def direction_vectors(self, normalize: bool = True) -> np.ndarray:
        _, s, _, _, _, _, _ = self.rays_by_mask(ret=[0, 1, 0, 0, 0, 0, 0], normalize=normalize)
        return s

    def rays_by_mask(self, ch=None, ch2=None, ret=None, normalize: bool = True):
        """Selective fetch (reference :235-293): directions are
        reconstructed as p[i+1] − p[i].

        :return: (p, s, pol, w, wl, snum, n), None where not requested
        """
        assert self.N, "ray_source_list has no rays stored."
        ret = [1, 1, 1, 1, 1, 1, 1] if ret is None else ret
        ch = np.ones(self.N, dtype=bool) if ch is None else ch
        ch2 = slice(None) if ch2 is None else ch2
        assert ch.shape[0] == self.N

        snums = None
        if ret[5]:
            ind = np.nonzero(ch)[0]
            snums = np.zeros_like(ind, dtype=int)
            for i, _ in enumerate(self.N_list):
                Ns, Ne = self.B_list[i:i + 2]
                snums[(Ns <= ind) & (ind < Ne)] = i

        s = None
        if ret[1]:
            if not isinstance(ch2, slice):
                ch21 = np.where(ch2 < self.Nt - 1, ch2 + 1, ch2)
                s = self.p_list[ch, ch21] - self.p_list[ch, ch2]
                if normalize:
                    s = _normalize_rows(s)
            else:
                s = self.p_list[ch, 1:] - self.p_list[ch, :-1]
                s = np.concatenate((s, np.zeros((s.shape[0], 1, 3))), axis=1)
                if normalize:
                    s = _normalize_rows(s)

        return (self.p_list[ch, ch2] if ret[0] else None,
                s,
                self.pol_list[ch, ch2] if ret[2] else None,
                self.w_list[ch, ch2] if ret[3] else None,
                self.wl_list[ch] if ret[4] else None,
                snums,
                self.n_list[ch, ch2] if ret[6] else None)
