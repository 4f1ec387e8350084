from repro_torch.data.pipeline import (DataPipeline, SyntheticLM,
                                       SyntheticTranslation, make_pipeline)
from repro_torch.data.tokenizer import ToyTokenizer
