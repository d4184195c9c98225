from repro_torch.data.chunking import chunk_text  # noqa
from repro_torch.data.tokenizer import HashingTokenizer  # noqa
from repro_torch.data.embedder import (HashingEmbedder, ModelEmbedder,  # noqa
                                       TableEmbedder)
from repro_torch.data.synthetic import (BEIR_SPECS, SyntheticDataset,  # noqa
                                        generate_dataset, scaled_beir)
