"""Observability subsystem: coded events, pluggable sinks, typed errors.

Covers reference components #15-#17 (``matchering/log/``).
"""

from .codes import Code
from .exceptions import ModuleError
from .explanations import explain, explain_with_code, get_explanation_handler
from .handlers import debug, debug_line, info, set_handlers, warning

__all__ = [
    "Code",
    "ModuleError",
    "explain",
    "explain_with_code",
    "get_explanation_handler",
    "debug",
    "debug_line",
    "info",
    "set_handlers",
    "warning",
]
