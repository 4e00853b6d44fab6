"""Fault tolerance for streamed mining: resumable checkpoints
(:mod:`repro_torch.distributed.checkpoint`) and the retrying SON phase-1
executor (:mod:`repro_torch.distributed.fault_tolerance`)."""
