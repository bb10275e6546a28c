"""Images scored over the whole window, as ``serve_imgs_per_s`` reads
served ones: every call of the window, on the host's clock."""

from yolo_bench.metrics._common import reader_of

read = reader_of("serve_imgs_per_s")
