"""SHA-256 digests of Pillow 12.1.0's readings of the fixtures beside this
module and of its JPEG encodes (``save``, quality 75, 4:2:0) of
``seeded_images()``; each decode is ``convert("RGBA")``'s bytes. The WebP
files' also as OpenCV 5.0.0 reads them (``WEBP_DECODE_CV2``: the bytes of
``imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``). ``ENCODE``: the SHA-256
of each encode fixture's bytes (Pillow's ``save`` of its source). Written by
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
WEBP_DECODE = {
    "alpha.webp": "fe89578e53dbec75d17e5fc09eaadbe87b4d9c8aecc7a8c86b225647c3082078",
    "anim.webp": "a728be0de4d2750149a7dc64fc23015f745e66c28dea0f4bbf2e9038d456dbb2",
    "blob_basecolor.webp": "8f0370cfff0b870f216c7915cc218522e3b0d7313f86715968ae94d87565cd37",
    "checker.webp": "762cf7a520d32fe2634a4e80afd0c8630d2ada43487b8cdee4a41aa3b9c3eaf0",
    "frame.webp": "a6da0ca9565dbc6083e99950e99467171fa4ba36c34822ef0426ca73eeaef7be",
    "frame_lossless.webp": "2810884bdba1a90a5f57be973a313a2c4d03ea283a50cd238414d0c1fab721d1",
    "lossless.webp": "d8be627f3d878d1f5012c11ff9da4d39319ef71a7f8bb5443dee24cd3386a137",
    "odd.webp": "399786a5940605860b4e0e4a8fd870dbc47fda07fdc96283cdbce08ca669c536",
    "palette16.webp": "dcdc30b04e9b468a6661d308be288b9c8ec5806171bce2194381960e4377d846",
    "q80.webp": "9a1e66fad6191c99865f7609c7e9ff75d68cdb7dc1e4a5c85bc421050c1d079a",
    "sky.webp": "5a908dc7642affe827b555be33419f12703ad71f304487ace33ea59a58eafccc",
}
WEBP_DECODE_CV2 = {
    "alpha.webp": "e99de1fa375b3fe4c2515ee07663c19d0fe76275dccc0d59b229eca4b818adcd",
    "anim.webp": "4c6590772800d126b050a06af726104cedbb7cd629670b6396b6f14ee7edeeb7",
    "blob_basecolor.webp": "82e6e774d6db36d4dc635c045ab25203e38cfcd1a0d0d7f6fe28e03b905f4473",
    "checker.webp": "96263cb4d455c8a26fa11d44b53e89b7bc652283f6b0db8b5c9d1832e19bc02d",
    "frame.webp": "030bf0af77f7bdecab40e5e268ddc67b5192424bf2e6dc63b608205bed831c64",
    "frame_lossless.webp": "7e877f16a869e16871aaeff8bc49fc07d744b82245800fa50878ed9d3897abb1",
    "lossless.webp": "4288035006c860fdca22bcc7bd996cad369c7c3627f9d44fcecdd61d9e1db878",
    "odd.webp": "6cf4f2fab0fb3e502cb01e1a9ba3eca7909aacf7189675879f07750fe2a8d9a4",
    "palette16.webp": "72940b0286163409fa80dba5780ed3c348a1c9b75bea02ecf52775f635902b10",
    "q80.webp": "d82ddf6b55fdfeaece74d9cde73b555399146994e73b7d5315435e0f0cfd0ec2",
    "sky.webp": "095b5e558bdf5a98aa3829fc0efaadd765d8cada588f8ace8f9b10f52e4964d4",
}
ENCODE = {
    "depth16.gif": "7debf3969d9f09fda5c83ddcda6e51fb4d55fec53c7b5e024dca77c33dad62a1",
    "depth16.pgm": "2159a644de80ad23dbcd72513c03dc0241d0298dfd0b3c208b756ece21876a86",
    "frame.ppm": "ec0335d667ffb160a4308c6681b431869b66749a5efaec8e7cd68d99c8289d4c",
    "noise.gif": "f5a0c193d92d160c2b5b91111b48c54701cf55e8f7144ba2fd3553a4828aa062",
    "ramp.gif": "d4c040d3b48eb984bceecd7c638ce1be3663eebfa1ae71d9986775ae6b72770e",
    "rgba.gif": "c1818e5c256e9aa38e629387b9a598571a9ea6e034d96e4b042e3be15523b433",
}
