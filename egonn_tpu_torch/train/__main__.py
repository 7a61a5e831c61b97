"""`python -m egonn_tpu_torch.train`: see `train/cli.py`."""
from egonn_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
