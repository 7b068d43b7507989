from repro_torch.data.partition import label_skew_partition  # noqa: F401
from repro_torch.data.pipeline import (ClientBatcher,  # noqa: F401
                                       JitProceduralBatcher,
                                       ProceduralBatcher, TokenBatcher)
from repro_torch.data.synthetic import (make_classification,  # noqa: F401
                                        make_token_stream)
