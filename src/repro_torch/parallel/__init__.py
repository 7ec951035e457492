"""The port's parallel layer on ``torch.distributed``: the CMP-windowed
1F1B pipeline (:mod:`.pipeline`), the 2-D FSDP x TP layouts as DTensor
placements (:mod:`.sharding`) and the process-group collectives
(:mod:`.collectives`)."""
