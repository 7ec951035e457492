"""``python -m repro_torch.net`` — host worker entry point for the wire
transport (spec line on stdin, ``PORT <n>`` on stdout; see
:func:`repro_torch.net.server.worker_main`)."""

from repro_torch.net.server import main

main()
