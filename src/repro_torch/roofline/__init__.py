"""The dry-run plans' roofline (counterpart of `repro/roofline/`)."""
from repro_torch.roofline.analysis import (HW, analyze_plan,  # noqa: F401
                                           roofline_terms)
