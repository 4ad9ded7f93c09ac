"""Method (classifier) registry."""

# register the classifiers
from . import (  # noqa: F401
    atl_net, can, deepbdc, dn4, dsn, feat, frn, kendall, local_metrics, mcl, meta_baseline,
    proto_net, relation_net)
