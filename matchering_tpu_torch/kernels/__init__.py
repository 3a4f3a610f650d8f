"""The port's hand-written CUDA kernels and their plain PyTorch twins.

* ``envelope`` — K1, the limiter front end (``csrc/envelope.cu``);
* ``scan`` — K2, the first-order IIR scan (``csrc/scan.cu``);
* ``sos`` — K3, the second-order-section scan (``csrc/sos_scan.cu``);
* ``back_end`` — K4, the limiter back end (``csrc/back_end.cu``).

Each wrapper runs its plain twin for a CPU tensor and launches its kernel
for a CUDA tensor, raising if it cannot; it never falls back from one to
the other.  Each call that launches a kernel adds one to its counter in
``trace`` (``launch.k1`` to ``launch.k4``) and sets the
module's ``LAST_GRID``, the blocks of that launch.
"""
