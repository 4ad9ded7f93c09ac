"""Method (classifier) registry."""

# register the classifiers
from . import atl_net, deepbdc, dn4, local_metrics, mcl, proto_net, relation_net  # noqa: F401
