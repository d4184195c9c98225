from repro_torch.serving.engine import (BatchJob, GeneratorModel,  # noqa
                                        RAGEngine, RAGResponse)
from repro_torch.serving.batching import ContinuousBatcher  # noqa
from repro_torch.serving.pipeline import (PipelineBatch, PipelineTrace,  # noqa
                                          StagedPipeline)
from repro_torch.serving.scheduler import (Request,  # noqa
                                           RequestScheduler,
                                           TokenBucketAdmission)
from repro_torch.serving.simulator import (EdgeSimulator,  # noqa
                                           TenantTrace, simulate_ttft,
                                           zipf_over_tenants)
