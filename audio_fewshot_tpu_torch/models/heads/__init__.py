"""Method (classifier) registry."""

from . import deepbdc, proto_net  # noqa: F401  (register DeepBDC and ProtoNet)
