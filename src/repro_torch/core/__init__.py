# GRE's Scatter-Combine computation model and the BSP engine that runs it.
from repro_torch.core.vertex_program import (MONOIDS, Monoid, VertexProgram,
                                             segment_combine)
from repro_torch.core.engine import DevicePartition, EngineState, GREEngine
from repro_torch.core.plan import FrontierPlan, SuperstepPlan, execute_plan
from repro_torch.core import algorithms
