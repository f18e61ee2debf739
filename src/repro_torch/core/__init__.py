# Placement core: MIG device models, mask tables, policy core, replay.
