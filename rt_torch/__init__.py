"""rt_torch — the PyTorch/CUDA port of the ``rt`` path tracer.

Same module layout as ``rt`` so each file's counterpart is easy to find.
The package imports ``torch`` and ``numpy`` only; it shares no code with
``rt`` (OBJ assets are read from ``rt/scene/assets`` by path — data, not an
import).  Entry points take an explicit ``device`` and default to
``"cuda"``; the hand-written kernels under ``kernels/csrc`` are compiled at
first use on a CUDA tensor, never at import.
"""

__version__ = "0.1.0"
