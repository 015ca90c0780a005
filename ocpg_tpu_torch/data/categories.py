"""Category tables of Ref-YouTube-VOS and Ref-DAVIS: a copy of
``ocpg_tpu/data/categories.py`` (the reference's ``datasets/categories.py``)."""

YTVOS_CATEGORIES = {
    'airplane': 1, 'ape': 2, 'bear': 3, 'bike': 4, 'bird': 5, 'boat': 6,
    'bucket': 7, 'bus': 8, 'camel': 9, 'cat': 10, 'cow': 11, 'crocodile': 12,
    'deer': 13, 'dog': 14, 'dolphin': 15, 'duck': 16, 'eagle': 17,
    'earless_seal': 18, 'elephant': 19, 'fish': 20, 'fox': 21, 'frisbee': 22,
    'frog': 23, 'giant_panda': 24, 'giraffe': 25, 'hand': 26, 'hat': 27,
    'hedgehog': 28, 'horse': 29, 'knife': 30, 'leopard': 31, 'lion': 32,
    'lizard': 33, 'monkey': 34, 'motorbike': 35, 'mouse': 36, 'others': 37,
    'owl': 38, 'paddle': 39, 'parachute': 40, 'parrot': 41, 'penguin': 42,
    'person': 43, 'plant': 44, 'rabbit': 45, 'raccoon': 46, 'sedan': 47,
    'shark': 48, 'sheep': 49, 'sign': 50, 'skateboard': 51, 'snail': 52,
    'snake': 53, 'snowboard': 54, 'squirrel': 55, 'surfboard': 56,
    'tennis_racket': 57, 'tiger': 58, 'toilet': 59, 'train': 60, 'truck': 61,
    'turtle': 62, 'umbrella': 63, 'whale': 64, 'zebra': 65,
}

DAVIS_CATEGORIES = {
    'airplane': 1, 'backpack': 2, 'ball': 3, 'bear': 4, 'bicycle': 5,
    'bird': 6, 'boat': 7, 'bottle': 8, 'box': 9, 'bus': 10, 'camel': 11,
    'car': 12, 'carriage': 13, 'cat': 14, 'cellphone': 15, 'chamaleon': 16,
    'cow': 17, 'deer': 18, 'dog': 19, 'dolphin': 20, 'drone': 21,
    'elephant': 22, 'excavator': 23, 'fish': 24, 'goat': 25, 'golf cart': 26,
    'golf club': 27, 'grass': 28, 'guitar': 29, 'gun': 30, 'helicopter': 31,
    'horse': 32, 'hoverboard': 33, 'kart': 34, 'kite': 35, 'koala': 36,
    'leash': 37, 'lion': 38, 'lock': 39, 'mask': 40, 'microphone': 41,
    'monkey': 42, 'motorcycle': 43, 'oar': 44, 'paddle': 45, 'paper': 46,
    'paraglide': 47, 'person': 48, 'pig': 49, 'pole': 50, 'potted plant': 51,
    'puck': 52, 'rack': 53, 'rhino': 54, 'rope': 55, 'sail': 56,
    'scale': 57, 'scooter': 58, 'selfie stick': 59, 'sheep': 60, 'skateboard': 61,
    'ski': 62, 'ski poles': 63, 'snake': 64, 'snowboard': 65, 'stick': 66,
    'stroller': 67, 'surfboard': 68, 'swing': 69, 'tennis racket': 70,
    'tractor': 71, 'trailer': 72, 'train': 73, 'truck': 74, 'turtle': 75,
    'varanus': 76, 'violin': 77, 'wheelchair': 78,
}
