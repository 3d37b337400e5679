"""PyTorch / CUDA port of the SHIELD8-UAV detector serving path.

The package mirrors ``repro``'s layout (``core``, ``models``, ``kernels``,
``serving``, ``data``, ``distributed``) so each module's counterpart is easy
to find.  It
imports ``torch`` and numpy only: nothing of JAX and nothing of ``repro``.

Public functions keep the reference's NWC activation layout ``(B, L, C)``
and its ``(frames, channels)`` row-major flatten.  Entry points
(``accelerator_forward``, ``MonitorEngine``, ``FleetSupervisor``,
``quantize_params``, ``load_artifact``) run on ``device="cuda"`` unless the caller asks for
``device="cpu"``; without a GPU they raise instead of falling back.
"""
