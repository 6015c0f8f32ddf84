from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

__all__ = ["TrainLoop", "TrainLoopConfig", "build_train_step"]
