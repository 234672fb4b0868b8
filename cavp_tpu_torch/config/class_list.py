"""Class index tables of the AVS and VPO setups
(``cavp_tpu/config/class_list.py``).

The reference's ``config/class_list.py``: the 24-entry AVS table
(background and 23 sounding categories), the 22-entry VPO/COCO table,
and the COCO category id -> VPO class name map that decodes the VPO
masks (person split into the male/female/baby pseudo-ids 92/93/94).
"""

INDEX_TABLE_AVS = [
    "background",
    "ambulance_siren",
    "baby_laughter",
    "cap_gun_shooting",
    "cat_meowing",
    "chainsawing_trees",
    "coyote_howling",
    "dog_barking",
    "driving_buses",
    "female_singing",
    "helicopter",
    "horse_clip-clop",
    "lawn_mowing",
    "lions_roaring",
    "male_speech",
    "mynah_bird_singing",
    "playing_acoustic_guitar",
    "playing_glockenspiel",
    "playing_piano",
    "playing_tabla",
    "playing_ukulele",
    "playing_violin",
    "race_car",
    "typing_on_computer_keyboard",
]

INDEX_TABLE_COCO = [
    "background",
    "airplane",
    "baby",
    "bird",
    "bus",
    "car",
    "cat",
    "cell phone",
    "cow",
    "dog",
    "elephant",
    "female",
    "horse",
    "keyboard",
    "male",
    "motorcycle",
    "mouse",
    "sheep",
    "skateboard",
    "sports ball",
    "tennis racket",
    "zebra",
]

# COCO category id -> VPO class name (person split into male/female/baby
# pseudo-ids 92/93/94 as in the reference).
COCO_CLASS_DICT = {
    "5": "airplane",
    "16": "bird",
    "6": "bus",
    "3": "car",
    "17": "cat",
    "77": "cell phone",
    "21": "cow",
    "18": "dog",
    "22": "elephant",
    "19": "horse",
    "76": "keyboard",
    "4": "motorcycle",
    "74": "mouse",
    "20": "sheep",
    "41": "skateboard",
    "37": "sports ball",
    "43": "tennis racket",
    "24": "zebra",
    "92": "male",
    "93": "female",
    "94": "baby",
}

