"""Fault tolerance for the port's trainer: fault injection, heartbeats and
failure detection, the restart policy, elastic replanning and the
Supervisor (the JAX package's `runtime/`)."""
from repro_torch.runtime.fault import (FailureDetector, Heartbeat, HeartbeatStore,
                                       RestartPolicy, StepTimer)
from repro_torch.runtime.elastic import ElasticDecision, replan_mesh, apply_decision
from repro_torch.runtime.inject import (FaultEvent, FaultInjector, FaultPlan,
                                        InjectedFault)
from repro_torch.runtime.supervisor import (RestartBudgetExhausted, SupervisedResult,
                                            Supervisor)

__all__ = ["FailureDetector", "Heartbeat", "HeartbeatStore", "RestartPolicy",
           "StepTimer", "ElasticDecision", "replan_mesh", "apply_decision",
           "FaultEvent", "FaultInjector", "FaultPlan", "InjectedFault",
           "RestartBudgetExhausted", "SupervisedResult", "Supervisor"]
