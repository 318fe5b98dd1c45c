"""Entry point of the sweep server: ``python -m repro_torch.service``.

The implementation lives in :mod:`repro_torch.core.service`; this shim
makes the service addressable without knowing the package layout.
Requests run on the card (``--device cuda``, the default, raises
without one); ``--device cpu`` runs the plain PyTorch path."""

from .core.service import (CancelledError, ServiceClosedError,  # noqa: F401
                           SweepRequest, SweepService, Ticket, main)

if __name__ == "__main__":      # pragma: no cover
    import sys
    sys.exit(main())
