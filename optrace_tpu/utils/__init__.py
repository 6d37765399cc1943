"""Infrastructure utilities: options, warnings, validation, progress.

Rebuild of the reference L0 layer (see SURVEY.md §2.1;
reference: optrace/global_options.py, optrace/warnings.py,
optrace/property_checker.py, optrace/progress_bar.py).
"""

from .global_options import global_options  # noqa: F401
from .warnings import OptraceWarning, warning  # noqa: F401
from .property_checker import PropertyChecker  # noqa: F401
from .progress_bar import ProgressBar  # noqa: F401
from .base_class import BaseClass  # noqa: F401
