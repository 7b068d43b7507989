from repro_torch.core.algorithms import (algorithm_assumes,  # noqa: F401
                                         algorithm_names, make_algorithm,
                                         register_algorithm)
from repro_torch.core.baselines import (CAFed, BiasedFedAvg,  # noqa: F401
                                        FedAR, FedAvgIS, FedAvgSampling,
                                        FedBuffAvg, SCAFFOLDSampling)
from repro_torch.core.local_update import (client_updates,  # noqa: F401
                                           device_update)
from repro_torch.core.mifa import MIFA  # noqa: F401
from repro_torch.core.participation import (  # noqa: F401
    AdversarialParticipation, BernoulliParticipation, TauStats,
    TraceParticipation, label_correlated_probs, tau_matrix)
from repro_torch.core.runner import FLHistory, RoundRunner, run_fl  # noqa: F401
from repro_torch.core.scan_engine import ScanDriver, scan_supported  # noqa: F401
