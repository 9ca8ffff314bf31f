"""Application layer: host orchestration (RadioController) and the CLI
(port of qradiolink_tpu/app: controller, cli and limits; the headless
service's command processor, telnet and GPredict servers and the MMDVM
session are not ported yet)."""

from qradiolink_tpu_torch.app.controller import RadioController, RxEvent  # noqa: F401
