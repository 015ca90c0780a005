"""Native (C++) components of the port: ``io``, the libjpeg/libpng and COCO
RLE codec of the data path (built with g++ at first use)."""
