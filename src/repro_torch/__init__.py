"""repro_torch: the PyTorch / CUDA port of the DOSC power-estimation
framework (Gomez & Patel et al., "Distributed On-Sensor Compute System
for AR/VR Devices", tinyML'22), beside the JAX reference package
``repro``.

Entry points (``core.sweep.evaluate_grid``, ``core.stream.stream_grid``)
run on the CUDA device by default and raise without one unless called
with ``device="cpu"``.
"""

__version__ = "0.1.0"
