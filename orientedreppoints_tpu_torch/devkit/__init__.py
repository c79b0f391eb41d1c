"""The DOTA devkit's host code in numpy: labelTxt files, exact polygon
IoU and NMS, tiling, COCO-poly json, the DOTA and HRSC preparation, the
Task1 and mAOE evaluators and the cross-tile result merge."""
