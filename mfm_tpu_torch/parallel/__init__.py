# mfm_tpu_torch.parallel.distributed (seed replication across processes) is
# not imported here: a process imports it at its start and brings the group
# up itself (initialize_distributed).
