from repro_torch.data.pipeline import (DataPipeline, SyntheticLM,
                                       SyntheticTranslation, make_pipeline)
