"""Application layer: host orchestration (RadioController), the MMDVM
session, the headless service's command processor, telnet and GPredict
servers, and the CLI (port of qradiolink_tpu/app)."""

from qradiolink_tpu_torch.app.controller import RadioController, RxEvent  # noqa: F401
