"""optrace_tpu — a differentiable sequential raytracer in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
optics package (drocheam/optrace, see SURVEY.md): sequential Monte-Carlo
raytracing, spectrally accurate detector-image rendering, paraxial (ABCD)
analysis, PSF convolution, ZEMAX import, HURB edge diffraction — designed
for sharded execution over device meshes with full autodiff through
surface, material and spectrum parameters.
"""

from .utils import global_options, OptraceWarning, warning, BaseClass  # noqa: F401
from . import color  # noqa: F401
from . import ops  # noqa: F401

from .spectrum import Spectrum, LightSpectrum, TransmissionSpectrum, RefractionIndex  # noqa: F401
from .geometry import (Surface, CircularSurface, RingSurface, ConicSurface,  # noqa: F401
                       SphericalSurface, AsphericSurface, TiltedSurface,
                       RectangularSurface, SlitSurface,
                       FunctionSurface1D, FunctionSurface2D,
                       DataSurface1D, DataSurface2D,
                       Point, Line, Element, Lens, IdealLens, Filter, Aperture,
                       Detector, RaySource, Group, PointMarker, LineMarker,
                       Volume, BoxVolume, SphereVolume, CylinderVolume)
from .image import RGBImage, GrayscaleImage, ScalarImage, RenderImage  # noqa: F401
from .tracer import Raytracer, RayStorage  # noqa: F401
from .analysis import TMA, convolve  # noqa: F401
from .io import load_agf, load_zmx  # noqa: F401
from . import presets  # noqa: F401

from .metadata import version, __version__  # noqa: F401
