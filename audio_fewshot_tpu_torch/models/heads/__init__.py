"""Method (classifier) registry."""

# register the classifiers
from . import (  # noqa: F401
    atl_net, can, cpea, deepbdc, dn4, dsn, feat, finetuning, frn, ifsl, kendall, leo,
    local_metrics, maml, mcl, meta_baseline, metal, mtl, pretrains, proto_net, r2d2,
    relation_net, renet, versa)
