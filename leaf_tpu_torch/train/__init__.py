"""The LEAF trainer of the port: schedules, optimizer, train step, epoch
loop and driver (`python -m leaf_tpu_torch.train.driver`)."""
