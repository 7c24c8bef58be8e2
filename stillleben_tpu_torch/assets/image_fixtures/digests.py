"""SHA-256 digests of Pillow 12.1.0's readings of the fixtures beside this
module and of its JPEG encodes (``save``, quality 75, 4:2:0) of
``seeded_images()``; each decode is ``convert("RGBA")``'s bytes. Written by
``tests/torch_image_fixtures.py --write``."""

DECODE = {
    "deflate.tif": "d8be627f3d878d1f5012c11ff9da4d39319ef71a7f8bb5443dee24cd3386a137",
    "interlaced.gif": "b8c9c3f902d4950b5cbba50d4db11fbd371d6babbc87f0a2b1445deec917092d",
    "lzw.tif": "692f15a0206184bafe9b224df96a6a882bba36904ccb1e2d555a99be61b15b56",
    "progressive.jpg": "a33d0795ab4e5da024d2df597ec28fc99b50cd97f1531550a010bcfa5752eb3c",
    "rle.tga": "d8be627f3d878d1f5012c11ff9da4d39319ef71a7f8bb5443dee24cd3386a137",
    "rle8.bmp": "75964b3c44c06c0471e9bc0e42ee20670bac59b776e41b0476f7ec02d635e67b",
}
JPEG_ENCODE = {
    "texture": "78b931e3e13a2d47c50f5a45042deb53421ecd11299d868cd05f119dd7077795",
    "frame": "ce0532d3a7f63440f594a3853c637a7b63354b6b5679e9cb5cbef083cdc5a650",
}
JPEG_ENCODE_DECODE = {
    "texture": "ff0a2bc4caf33892731f16ea682e430d2401fabeae7aa5cdfa023c12eaebc36d",
    "frame": "69af47efc777edc0449a743b916f2045ad90c608bce8ee5966c8100c81bf1ab3",
}
