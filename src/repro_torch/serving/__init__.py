from repro_torch.serving.engine import (BatchJob, GeneratorModel,  # noqa
                                        RAGEngine, RAGResponse)
