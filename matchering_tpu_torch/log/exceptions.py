"""Typed, machine-readable failure model.

Parity with reference ``matchering/log/exceptions.py:25-27``: the pipeline
fails fast with a :class:`ModuleError` whose message embeds the numeric code
(always code-prefixed, regardless of handler configuration).
"""

from .codes import Code
from .explanations import explain_with_code


class ModuleError(Exception):
    """Pipeline error carrying a machine-readable :class:`Code`."""

    def __init__(self, code: Code):
        self.code = code
        super().__init__(explain_with_code(code))
