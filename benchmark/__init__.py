"""The benchmark of the PyTorch/CUDA port (``stm32f4_sdr_gps_torch``).

``run`` runs one cell of ``BENCHMARK.json``; ``spec`` finds a cell's
configuration (``configs/``), traffic (``traffic/``) and per-layer metric
readers (``metrics/``) by name; ``scene`` and ``gen`` make the captures
from the seed; ``jobs`` drives the program; ``truth`` is the plain
reference and the comparison that decides ``correct``; ``trace`` reads
the device trace; ``roofline`` holds the card's peaks and K1's work;
``readings`` is the tool the limits of ``correct`` were set with.  Nothing here imports JAX or the JAX package, and the
reference imports nothing of the port.
"""
