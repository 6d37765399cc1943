"""Global option singleton.

Behavioral parity with the reference's ``optrace/global_options.py:8-97``
(ClassGlobalOptions): wavelength range, progress-bar/warning toggles, dark
mode for plots, spectral colormap hook, and context managers.

Additions of this package: ``float_dtype`` (f32 on the device) and
``mesh_axis_name`` used by the sharded trace path. The reference's
``multithreading`` flag is kept for API compatibility but only gates
host-side helpers — device parallelism is controlled by jax meshes
instead.
"""

import contextlib
from typing import Callable, Optional


class _GlobalOptions:

    def __init__(self) -> None:
        self._multithreading: bool = True
        self._show_progress_bar: bool = True
        self._show_warnings: bool = True
        self._wavelength_range: list = [380.0, 780.0]
        self._spectral_colormap: Optional[Callable] = None
        self._plot_dark_mode: bool = True
        self._ui_dark_mode: bool = True
        # additions of this package
        self._float_dtype = "float32"
        self._mesh_axis_name: str = "rays"

    # ------------------------------------------------------------------
    @property
    def multithreading(self) -> bool:
        return self._multithreading

    @multithreading.setter
    def multithreading(self, val: bool) -> None:
        self._check_bool("multithreading", val)
        self._multithreading = val

    @property
    def show_progress_bar(self) -> bool:
        return self._show_progress_bar

    @show_progress_bar.setter
    def show_progress_bar(self, val: bool) -> None:
        self._check_bool("show_progress_bar", val)
        self._show_progress_bar = val

    @property
    def show_warnings(self) -> bool:
        return self._show_warnings

    @show_warnings.setter
    def show_warnings(self, val: bool) -> None:
        self._check_bool("show_warnings", val)
        self._show_warnings = val

    @property
    def wavelength_range(self) -> list:
        return self._wavelength_range

    @wavelength_range.setter
    def wavelength_range(self, val) -> None:
        if not isinstance(val, (list, tuple)) or len(val) != 2:
            raise TypeError("wavelength_range must be a 2-element list.")
        lo, hi = float(val[0]), float(val[1])
        if lo > 380.0 or hi < 780.0:
            # the reference requires the range to include the visible band
            # (global_options wavelength bounds semantics)
            raise ValueError("wavelength_range must include [380, 780] nm.")
        self._wavelength_range = [lo, hi]

    @property
    def spectral_colormap(self) -> Optional[Callable]:
        return self._spectral_colormap

    @spectral_colormap.setter
    def spectral_colormap(self, val: Optional[Callable]) -> None:
        if val is not None and not callable(val):
            raise TypeError("spectral_colormap must be callable or None.")
        self._spectral_colormap = val

    @property
    def plot_dark_mode(self) -> bool:
        return self._plot_dark_mode

    @plot_dark_mode.setter
    def plot_dark_mode(self, val: bool) -> None:
        self._check_bool("plot_dark_mode", val)
        self._plot_dark_mode = val

    @property
    def ui_dark_mode(self) -> bool:
        return self._ui_dark_mode

    @ui_dark_mode.setter
    def ui_dark_mode(self, val: bool) -> None:
        self._check_bool("ui_dark_mode", val)
        self._ui_dark_mode = val

    # ---- options of this package ---------------------------------------
    @property
    def float_dtype(self) -> str:
        return self._float_dtype

    @float_dtype.setter
    def float_dtype(self, val: str) -> None:
        if val not in ("float32", "float64"):
            raise ValueError("float_dtype must be 'float32' or 'float64'.")
        self._float_dtype = val

    @property
    def mesh_axis_name(self) -> str:
        return self._mesh_axis_name

    @mesh_axis_name.setter
    def mesh_axis_name(self, val: str) -> None:
        if not isinstance(val, str):
            raise TypeError("mesh_axis_name must be a string.")
        self._mesh_axis_name = val

    # ------------------------------------------------------------------
    @staticmethod
    def _check_bool(name: str, val) -> None:
        if not isinstance(val, bool):
            raise TypeError(f"{name} must be bool.")

    @contextlib.contextmanager
    def no_progress_bar(self):
        """Context manager that temporarily disables the progress bar."""
        old = self._show_progress_bar
        self._show_progress_bar = False
        try:
            yield
        finally:
            self._show_progress_bar = old

    @contextlib.contextmanager
    def no_warnings(self):
        """Context manager that temporarily disables optrace warnings."""
        old = self._show_warnings
        self._show_warnings = False
        try:
            yield
        finally:
            self._show_warnings = old

    def __repr__(self) -> str:
        vals = {k.lstrip("_"): v for k, v in self.__dict__.items()}
        return f"GlobalOptions({vals})"


global_options = _GlobalOptions()
