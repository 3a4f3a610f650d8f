"""Pluggable logging sinks.

Same observability contract as reference ``matchering/log/handlers.py:24-83``:
three severity channels (info / warning / debug), silent by default, with a
fallback chain (unset channel -> default handler -> no-op).  Unlike the
reference's class-level mutable registry we keep a module-level immutable
``_Sinks`` record swapped atomically by :func:`set_handlers` — same semantics,
simpler to reason about under threads.
"""

from dataclasses import dataclass, field
from typing import Callable, Optional

from .codes import Code
from .explanations import get_explanation_handler

Handler = Callable[..., None]


def _silent(*_args, **_kwargs) -> None:
    pass


@dataclass(frozen=True)
class _Sinks:
    warning: Handler = _silent
    info: Handler = _silent
    debug: Handler = _silent
    explain: Callable[[Code], str] = field(default=get_explanation_handler(False))


_sinks = _Sinks()


def set_handlers(
    default_handler: Optional[Handler] = None,
    warning_handler: Optional[Handler] = None,
    info_handler: Optional[Handler] = None,
    debug_handler: Optional[Handler] = None,
    show_codes: bool = False,
) -> None:
    """Install logging sinks. Any unset channel falls back to
    ``default_handler``; if that is also unset the channel stays silent."""
    global _sinks
    fallback = default_handler if default_handler else _silent
    _sinks = _Sinks(
        warning=warning_handler or fallback,
        info=info_handler or fallback,
        debug=debug_handler or fallback,
        explain=get_explanation_handler(show_codes=show_codes),
    )


def warning(code: Code) -> None:
    _sinks.warning(_sinks.explain(code))


def info(code: Code) -> None:
    _sinks.info(_sinks.explain(code))


def debug(*args, **kwargs) -> None:
    _sinks.debug(*args, **kwargs)


def debug_line() -> None:
    debug("-" * 40)
