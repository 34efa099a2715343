"""The trainers of the port: LEAF (schedules, optimizer, train step, epoch
loop and driver, `python -m leaf_tpu_torch.train.driver`) and FARE
(`python -m leaf_tpu_torch.train.fare_driver`)."""
from leaf_tpu_torch.train.fare import (
    FareConfig,
    embedding_loss,
    encode_vision,
    make_fare_attack,
    make_fare_optimizer,
    make_fare_train_step,
    train_fare,
)

__all__ = [
    "FareConfig", "embedding_loss", "encode_vision", "make_fare_attack",
    "make_fare_optimizer", "make_fare_train_step", "train_fare",
]
