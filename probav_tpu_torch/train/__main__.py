"""``python3 -m probav_tpu_torch.train``: the training CLI (``cli.py``)."""

import logging

from probav_tpu_torch.train.cli import main

if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s - %(message)s",
                        level=logging.INFO)
    main()
