from repro_torch.train.optimizer import (adamw_init, adamw_update,  # noqa
                                         cosine_schedule, global_norm)
from repro_torch.train.train_step import (TrainState,  # noqa
                                          make_train_step, train_state_init)
from repro_torch.train.checkpoint import (load_checkpoint,  # noqa
                                          save_checkpoint)
