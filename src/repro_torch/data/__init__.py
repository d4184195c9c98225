from repro_torch.data.tokenizer import HashingTokenizer  # noqa
from repro_torch.data.embedder import HashingEmbedder, TableEmbedder  # noqa
from repro_torch.data.synthetic import (BEIR_SPECS, SyntheticDataset,  # noqa
                                        generate_dataset, scaled_beir)
