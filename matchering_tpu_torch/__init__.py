"""matchering_tpu_torch — audio matching & mastering on PyTorch and CUDA.

The PyTorch port of ``matchering_tpu``: given a TARGET track and a mastered
REFERENCE track, it produces a mastered TARGET with the reference's RMS,
frequency response, peak amplitude and stereo width.  It imports nothing
of the JAX package.

    import matchering_tpu_torch as mg
    mg.process(target="song.wav", reference="ref.wav",
               results=[mg.pcm16("out.wav")])

Many pairs at once go through ``process_batch`` with ``PairJob``s, which
pads them to shared buckets and masters each at its true length
(``matchering_tpu_torch.parallel``).  Entry points run on ``cuda`` unless
given ``device=``; with no card they raise.  The command line is
``python -m matchering_tpu_torch``.  ``limit`` runs on its tensor's device.
On CUDA the limiter runs hand-written kernels
(``matchering_tpu_torch.kernels``).
"""

__version__ = "0.1.0"
__title__ = "matchering_tpu_torch"

from . import ops
from .checker import check, check_equality
from .config import Config, LimiterConfig
from .core import process
from .farm import PairJob, process_batch
from .io import load, save
from .limiter import limit
from .log import Code, ModuleError
from .log import set_handlers as log
from .preview import create_preview
from .results import Result, pcm16, pcm24, pcm32f
from .stages import MasterOutput, master, master_graph

__all__ = [
    "Code",
    "Config",
    "LimiterConfig",
    "MasterOutput",
    "ModuleError",
    "PairJob",
    "Result",
    "check",
    "check_equality",
    "create_preview",
    "limit",
    "load",
    "log",
    "master",
    "master_graph",
    "ops",
    "pcm16",
    "pcm24",
    "pcm32f",
    "process",
    "process_batch",
    "save",
]
