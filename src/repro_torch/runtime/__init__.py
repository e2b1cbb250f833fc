"""repro_torch.runtime — LEA-coded data parallelism with retry / degrade
(:mod:`~repro_torch.runtime.fault_tolerance`) and the estimator's carry
across elastic pool resizes (:mod:`~repro_torch.runtime.elastic`)."""
