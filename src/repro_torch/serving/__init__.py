"""The serving plane of the port (``repro/serving``): the tiered engine,
scheduler, control-plane bridge and the live failover drill."""

from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.scheduler import (TieredScheduler,  # noqa: F401
                                           TierPolicy, default_policies)
from repro_torch.serving.failover import (FailoverBridge,  # noqa: F401
                                          ReplicaGroup, tier_live_fractions)
from repro_torch.serving.workload import (DrillReport, DrillSpec,  # noqa: F401
                                          TierVerdict, drill_oracle,
                                          request_campaign, run_drill)
